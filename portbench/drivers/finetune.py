"""Contrastive fine-tuning steps through ``CLIPTrainer.step``.

Set-up builds one trainer on the seeded f32 weights and makes
``batches`` seeded batches of ``batch`` frame-caption pairs on the card
(normalised f32 frames; captions of ``min_tokens``-``max_tokens`` ids
padded to 77), each row different. It drives the trainer through its
first ``check_steps`` steps on batches 0, 1, 2, ... with the window's own
call, records what the check needs, and hands the same trainer to the
window, which cycles on through the batches. ``train_fps`` counts the
pairs of the steps completed in the window over its seconds.

Correctness, on two stretches. The start: the reference
(``portbench/reference/train.py``, f32, TF32 off) follows the first
``check_steps`` steps from the same weights and batches. The end: once
the window has closed (and the memory peak is read), the trainer takes
one more step through the same call on the next batch of the cycle, and
the reference takes that step from the trainer's state as the window
left it (its parameters and AdamW moments and count): the reference
cannot redo the window's steps, so it follows the program from there.
For each stretch, ``loss_gap``: the widest relative gap of a step's
loss; ``grad_gap``: the worst leaf's gap between the norms of the
stretch's first gradient (the program's worked out from its AdamW
moments, ``(mu - b1 mu_before) / (1 - b1)``), against the larger of the
reference's norm of that leaf and of the median leaf; ``change_gap``:
the same of the norm of each leaf's change over the stretch. Leaves
whose reference gradient is under a thousandth of the median leaf's (a
key projection's bias under softmax) move under AdamW by rounding alone
and are left out of ``change_gap``. Each number is the wider of the two
stretches'.
"""

from __future__ import annotations

import statistics
import time

import torch

from portbench import gen, program
from portbench.reference import train as ref_train

B1 = 0.9


def _batches(ctx, first: int, count: int) -> list:
    tr, dev = ctx.traffic, ctx.device
    b = ctx.size("batch", tr["batch"])
    image = ctx.cfg["vision_config"]["image_size"]
    ctxlen = ctx.cfg["text_config"]["max_position_embeddings"]
    out = []
    for i in range(first, first + count):
        g = gen.generator(dev, ctx.seed, f"images/{i}")
        u8 = torch.randint(0, 256, (b, image, image, 3), generator=g,
                           device=dev, dtype=torch.uint8)
        ids = gen.caption_ids(dev, b, ctxlen, ctx.seed, f"captions/{i}",
                              tr["min_tokens"], tr["max_tokens"])
        out.append((gen.normalize_pixels(u8), ids))
    return out


def _norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tree.items()}


def setup(ctx) -> None:
    tr, dev = ctx.traffic, ctx.device
    trainer = program.trainer(ctx.cfg, dev, ctx.seed)
    batches = _batches(ctx, 0, ctx.size("batches", tr["batches"]))
    losses, grad_norms = [], None
    for i in range(tr["check_steps"]):
        pixels, ids = batches[i % len(batches)]
        losses.append(trainer.step(pixels, ids))
        if i == 0:
            grad_norms = {k: v / (1 - B1) for k, v in
                          _norms(trainer.state.opt_state["mu"]).items()}
    p0 = gen.weights(ctx.cfg, dev, program._DTYPES[ctx.cfg["train"]["dtype"]],
                     ctx.seed)
    change = {k: float(torch.linalg.vector_norm(
        (p.detach() - p0[k]).float()))
        for k, p in trainer.state.params.items()}
    del p0
    tokens = torch.cat([ids.argmax(dim=1) + 1 for _, ids in batches])
    ctx.state.update(trainer=trainer, batches=batches, step=tr["check_steps"],
                     caption_tokens=float(tokens.float().mean()),
                     program={"losses": losses, "grad_norms": grad_norms,
                              "change": change})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(ctx, tracer) -> dict:
    trainer, batches = ctx.state["trainer"], ctx.state["batches"]
    b = batches[0][0].shape[0]
    i = ctx.state["step"]
    steps = 0
    losses_finite = True
    t0 = time.perf_counter()
    ctx.mark_window_start(t0)
    end = t0 + ctx.seconds
    while True:
        now = time.perf_counter()
        tracer.tick(now - t0)
        if now >= end:
            break
        tracer.unit()
        pixels, ids = batches[i % len(batches)]
        loss = trainer.step(pixels, ids)
        losses_finite = losses_finite and loss == loss
        i += 1
        steps += 1
    tracer.stop()
    elapsed = time.perf_counter() - t0
    ctx.state["step"] = i
    return {
        "e2e": {"train_fps": steps * b / elapsed},
        "attempted": steps,
        "failed": 0 if losses_finite else 1,
        "counters": {}, "spans": {},
        "host": {"steps": steps, "batch": b, "elapsed_s": elapsed},
    }


def _clone(tree) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def release(ctx) -> None:
    """The end stretch's program side: one more step through
    ``CLIPTrainer.step`` from the state the window left, recorded with
    that state; then the trainer goes."""
    trainer = ctx.state.pop("trainer")
    batches = ctx.state.pop("batches")
    batch = ctx.state["step"] % len(batches)
    st = trainer.state
    start = {"params": _clone(st.params), "mu": _clone(st.opt_state["mu"]),
             "nu": _clone(st.opt_state["nu"]),
             "count": st.opt_state["count"]}
    loss = trainer.step(*batches[batch])
    mu = st.opt_state["mu"]
    got = {"losses": [loss],
           "grad_norms": {k: float(torch.linalg.vector_norm(
               (mu[k] - B1 * start["mu"][k]) / (1 - B1))) for k in mu},
           "change": {k: float(torch.linalg.vector_norm(
               (p.detach() - start["params"][k]).float()))
               for k, p in st.params.items()}}
    ctx.state["end"] = {"program": got, "start": start, "batch": batch}
    del trainer, st, mu, batches


def _reference(ctx, prec: str, half: bool = False) -> tuple:
    """The reference's first steps, and the state they leave; ``half``:
    each batch's first half alone (the fault of a step that leaves half
    of its batch out)."""
    tr = ctx.traffic
    params = gen.weights(ctx.cfg, ctx.device,
                         program._DTYPES[ctx.cfg["train"]["dtype"]], ctx.seed)
    params = {k: v.float().clone() for k, v in params.items()}
    p0 = {k: v.clone() for k, v in params.items()}
    batches = _batches(ctx, 0, tr["check_steps"])
    if half:
        batches = [(p[:p.shape[0] // 2], i[:i.shape[0] // 2])
                   for p, i in batches]
    out = ref_train.run_steps(params, ctx.cfg, batches,
                              ctx.cfg["train"]["learning_rate"],
                              ctx.cfg["train"]["weight_decay"], prec)
    out["change"] = {k: float(torch.linalg.vector_norm(params[k] - p0[k]))
                     for k in params}
    opt = out.pop("opt")
    return out, {"params": params, "mu": opt.mu, "nu": opt.nu,
                 "count": opt.count}


def _end_reference(ctx, start: dict, batch: int, prec: str,
                   half: bool = False) -> dict:
    """The reference's step on seeded batch ``batch`` from ``start`` (a
    state's parameters, AdamW moments and count), left as it was."""
    params = {k: v.float().clone() for k, v in start["params"].items()}
    opt = ref_train.AdamW(params, ctx.cfg["train"]["learning_rate"],
                          ctx.cfg["train"]["weight_decay"],
                          mu=_clone(start["mu"]), nu=_clone(start["nu"]),
                          count=start["count"])
    batches = _batches(ctx, batch, 1)
    if half:
        batches = [(p[:p.shape[0] // 2], i[:i.shape[0] // 2])
                   for p, i in batches]
    out = ref_train.run_steps(params, ctx.cfg, batches,
                              ctx.cfg["train"]["learning_rate"],
                              ctx.cfg["train"]["weight_decay"], prec, opt)
    out.pop("opt")
    out["change"] = {k: float(torch.linalg.vector_norm(
        params[k] - start["params"][k].float())) for k in params}
    return out


def _wider(a: dict, b: dict) -> dict:
    return {k: max(a[k], b[k]) for k in a}


def _gaps(got: dict, want: dict) -> dict:
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    if len(got["losses"]) != len(want["losses"]):
        loss_gap = float("inf")
    g_ref = want["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad_gap = max(abs(got["grad_norms"][k] - g_ref[k]) / max(g_ref[k],
                                                               g_med)
                   for k in g_ref)
    moving = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    c_ref = want["change"]
    c_med = statistics.median(c_ref[k] for k in moving)
    change_gap = max(abs(got["change"][k] - c_ref[k]) / max(c_ref[k], c_med)
                     for k in moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap}


def check(ctx) -> dict:
    want, _ = _reference(ctx, "f32")
    end = ctx.state["end"]
    start = _gaps(ctx.state["program"], want)
    del want
    return _wider(start, _gaps(end["program"], _end_reference(
        ctx, end["start"], end["batch"], "f32")))


def control(ctx, prec: str) -> dict:
    """The reference in ``prec`` in the program's place; ``prec``
    ``"half-batch"``: the f32 reference leaving half of each batch out.
    The end stretch starts from the f32 reference's state after the
    first steps, on the next batch of the cycle."""
    half = prec == "half-batch"
    low = prec if not half else "f32"
    want, state = _reference(ctx, "f32")
    got, _ = _reference(ctx, low, half)
    start = _gaps(got, want)
    del got, want
    batch = ctx.traffic["check_steps"] % ctx.size("batches",
                                                  ctx.traffic["batches"])
    end = _gaps(_end_reference(ctx, state, batch, low, half),
                _end_reference(ctx, state, batch, "f32"))
    return _wider(start, end)


def control_setup(ctx) -> None:
    pass
