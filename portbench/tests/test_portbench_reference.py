"""The plain reference: independent of the program, and equal to the
program's f32 module towers and trainer where both compute the same
function (tiny sizes on the CPU)."""

import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import clip as ref_clip
from portbench.reference import search as ref_search
from portbench.reference import tokenizer as ref_tok
from portbench.reference import train as ref_train
from portbench.tests import tiny

FORBIDDEN = ("video_quierer_tpu", "video_quierer_tpu_torch", "jax", "jaxlib",
             "flax")


def test_reference_imports_nothing_of_the_program():
    for path in (tiny.ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)
    code = ("import sys; import portbench.reference.clip, "
            "portbench.reference.search, portbench.reference.tokenizer, "
            "portbench.reference.train, portbench.gen; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=tiny.ROOT)


@pytest.fixture(scope="module")
def port():
    tiny.register()
    from video_quierer_tpu_torch.models.clip.config import get_config
    from video_quierer_tpu_torch.models.clip.model import CLIP
    cfg = tiny.config()
    sd = gen.weights(cfg, "cpu", torch.float32, 7)
    model = CLIP(get_config(tiny.PORT_NAME))
    model.load_state_dict(sd)
    return cfg, sd, model.eval()


def test_tokenizer_is_the_programs():
    from video_quierer_tpu_torch.models.clip.tokenizer import HashTokenizer
    queries = gen.query_pool(3, 200, 500, 0.25, 60)
    assert np.array_equal(ref_tok.tokenize(queries),
                          HashTokenizer()(queries).astype(np.int64))


def test_towers_equal_the_programs_f32_towers(port):
    cfg, sd, model = port
    ids = torch.from_numpy(ref_tok.tokenize(gen.query_pool(5, 6, 50, 0.25,
                                                           60)))
    frames = torch.from_numpy(gen.frame_pool("cpu", 1, 4, 5)[0])
    px = gen.normalize_pixels(frames)
    with torch.no_grad():
        want_t, want_i = model.encode_text(ids), model.encode_image(px)
    got_t = ref_clip.encode_text(sd, cfg, ids)
    got_i = ref_clip.encode_image(sd, cfg, px)
    assert torch.allclose(got_t, want_t, atol=2e-6)
    assert torch.allclose(got_i, want_i, atol=2e-6)


def test_step_equals_the_programs_trainer(port):
    cfg, sd, _ = port
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer
    from video_quierer_tpu_torch.models.clip.config import get_config
    tr = CLIPTrainer(cfg=get_config(tiny.PORT_NAME), params=sd,
                     learning_rate=1e-5, weight_decay=0.01, device="cpu")
    g = torch.Generator().manual_seed(1)
    batches = [(gen.normalize_pixels(torch.randint(
        0, 256, (4, 224, 224, 3), generator=g, dtype=torch.uint8)),
        gen.caption_ids("cpu", 4, 77, 1, f"c{i}", 3, 9)) for i in range(2)]
    losses = [tr.step(p, i) for p, i in batches]
    params = {k: v.clone() for k, v in sd.items()}
    out = ref_train.run_steps(params, cfg, batches, 1e-5, 0.01)
    assert np.allclose(out["losses"], losses, rtol=1e-5)
    # leaves whose gradient is nought to rounding (a key's bias under
    # softmax) move under AdamW by rounding alone
    med = np.median(list(out["grad_norms"].values()))
    for k, p in tr.state.params.items():
        if out["grad_norms"][k] >= 1e-3 * med:
            assert torch.allclose(params[k], p.detach(), atol=1e-6), k


def test_step_from_the_programs_state(port):
    """The end stretch of the fine-tuning check: the reference's AdamW,
    started from the trainer's parameters, moments and count after some
    steps, takes the trainer's next step."""
    cfg, sd, _ = port
    from video_quierer_tpu_torch.train.trainer import CLIPTrainer
    from video_quierer_tpu_torch.models.clip.config import get_config
    tr = CLIPTrainer(cfg=get_config(tiny.PORT_NAME), params=sd,
                     learning_rate=1e-5, weight_decay=0.01, device="cpu")
    g = torch.Generator().manual_seed(2)
    batches = [(gen.normalize_pixels(torch.randint(
        0, 256, (4, 224, 224, 3), generator=g, dtype=torch.uint8)),
        gen.caption_ids("cpu", 4, 77, 2, f"c{i}", 3, 9)) for i in range(3)]
    for p, i in batches[:2]:
        tr.step(p, i)
    st = tr.state
    params = {k: v.detach().clone() for k, v in st.params.items()}
    opt = ref_train.AdamW(
        params, 1e-5, 0.01,
        mu={k: v.clone() for k, v in st.opt_state["mu"].items()},
        nu={k: v.clone() for k, v in st.opt_state["nu"].items()},
        count=st.opt_state["count"])
    loss = tr.step(*batches[2])
    out = ref_train.run_steps(params, cfg, batches[2:], 1e-5, 0.01,
                              opt=opt)
    assert np.allclose(out["losses"], [loss], rtol=1e-5)
    med = np.median(list(out["grad_norms"].values()))
    for k, p in st.params.items():
        if out["grad_norms"][k] >= 1e-3 * med:
            assert torch.allclose(params[k], p.detach(), atol=1e-6), k


def test_topk_is_exact():
    q = torch.nn.functional.normalize(torch.randn(3, 16), dim=1)
    chunks = list(gen.corpus_chunks("cpu", 1000, 16, 9))
    rows = torch.cat([c for _, c in chunks])
    want_v, want_i = torch.topk(q @ rows.t(), 5)
    v, i, picked = ref_search.topk_and_scores(chunks, q, 5, want_i)
    assert torch.equal(i, want_i) and torch.allclose(v, want_v)
    assert torch.allclose(picked, want_v)


@pytest.mark.parametrize("prec", ref_clip.PRECISIONS)
def test_rounding(prec):
    x = torch.randn(64, 64)
    r = ref_clip.round_to(x, prec)
    err = float(((r - x).abs() / x.abs().clamp(min=1e-3)).max())
    assert err <= {"f32": 0.0, "tf32": 2 ** -11, "fp8": 0.5}[prec] * 1.01
