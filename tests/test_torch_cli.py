"""The port's search REPL (``video_quierer_tpu_torch/cli.py``) against the
JAX package's (``video_quierer_tpu/cli.py``): each over its own copy of
the seeded cache of ``test_torch_engine_surface`` and the same tiny tower
(the engine class swapped for one that injects it), the same stdin gives
the same stdout apart from the banner's first line (which names the
package); ``--device`` defaults to ``cuda``.
"""

import io
import shutil
import sys

import pytest

from tests.test_torch_engine_surface import (
    MODEL,
    QUERIES,
    cache_file,  # noqa: F401  (a fixture)
    embedders,  # noqa: F401  (a fixture)
)
from tests.test_torch_slice import _config
import video_quierer_tpu.engine as jax_engine_pkg
from video_quierer_tpu import cli as jax_cli
from video_quierer_tpu.engine.config import EngineConfig as JaxConfig
from video_quierer_tpu.engine.system import VideoSearchEngine as JaxEngine
from video_quierer_tpu_torch import cli
from video_quierer_tpu_torch.engine.config import EngineConfig
from video_quierer_tpu_torch.engine.system import VideoSearchEngine

STDINS = {
    "quit": "\n".join([QUERIES[0], "", QUERIES[1], "  " + QUERIES[2],
                       "quit", QUERIES[3]]) + "\n",
    "eof": QUERIES[3] + "\n" + QUERIES[0],
    "exit_upper": "EXIT\n",
}


def _run(main, argv, stdin, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", argv)
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("case", list(STDINS))
def test_cli_output_matches_jax(tmp_path, cache_file, embedders,  # noqa: F811
                                monkeypatch, capsys, case):
    jax_emb, port_emb = embedders
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        shutil.copy(cache_file, dirs[name] / cache_file.name)
    monkeypatch.setattr(
        jax_engine_pkg, "VideoSearchEngine",
        lambda d: JaxEngine(d, config=_config(JaxConfig, d, MODEL),
                            embedder=jax_emb))
    monkeypatch.setattr(
        cli, "VideoSearchEngine",
        lambda d, device: VideoSearchEngine(
            d, config=_config(EngineConfig, d, MODEL), embedder=port_emb,
            device=device))
    want = _run(jax_cli.main, ["cli", "--videos-dir", str(dirs["jax"]),
                               "-k", "4"], STDINS[case], monkeypatch, capsys)
    got = _run(lambda: cli.main(None),
               ["cli", "--videos-dir", str(dirs["port"]), "-k", "4",
                "--device", "cpu"], STDINS[case], monkeypatch, capsys)
    assert got[0] == "Video Search (PyTorch/CUDA port) — interactive demo"
    assert got[1:] == want[1:]
    assert any(" at " in line and "(score " in line for line in got) \
        or case == "exit_upper"


def test_cli_defaults_to_the_card(monkeypatch):
    seen = {}

    class Stop(Exception):
        pass

    def factory(videos_dir, device):
        seen.update(videos_dir=videos_dir, device=device)
        raise Stop

    monkeypatch.setattr(cli, "VideoSearchEngine", factory)
    with pytest.raises(Stop):
        cli.main([])
    assert seen == {"videos_dir": "videos", "device": "cuda"}
