"""Device operations of a traced slice, grouped by the layer that issued
them. The card runs one stream, so the operations of a step come in the
order the program enqueued them:

- a search flush: the query ids' host-to-device copy, the text tower's
  kernels, the candidate scan (``cand_kernel``, B1), then the merge,
  the re-rank and the results' copies to the host;
- an ingest batch: the frames' copy, the preprocess (element-wise
  kernels), the fused vision encode (per block: B5 = ``ln_bf16``, the QKV
  ``gemm_wgmma``, ``attn_bf16``, the out-proj ``gemm_wgmma``; B6 =
  ``ln_bf16``, the fc1 ``gemm_wgmma`` with its GELU epilogue, the fc2
  ``gemm_wgmma``), the head, the fetch and the appends.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.trace import (
    DeviceOp,
    gemm_act,
    is_copy_dtoh,
    is_copy_htod,
    is_scan,
)


def is_copy(name: str) -> bool:
    return "Memcpy" in name or "Memset" in name or is_copy_htod(name) \
        or is_copy_dtoh(name)


def kernels(ops: List[DeviceOp]) -> List[DeviceOp]:
    return [o for o in ops if not is_copy(o.name)]


def search_flushes(ops: List[DeviceOp]) -> Tuple[list, list, list]:
    """``(text, scan, rest)`` lists of kernel ops: ``text`` the kernels
    after the last host-to-device copy before each scan (each flush's
    text tower), ``scan`` the scans, ``rest`` every kernel between a
    scan and the next flush's text. Only whole flushes (a scan with its
    text before it) are kept."""
    text, scan, rest = [], [], []
    seg: List[DeviceOp] = []
    seen_copy = False
    after_scan = False
    for o in ops:
        if is_scan(o.name):
            if seen_copy:
                text.append([k for k in seg if not is_copy(k.name)])
                scan.append(o)
            seg, seen_copy, after_scan = [], False, True
        elif is_copy_htod(o.name):
            if after_scan:
                rest.extend(k for k in seg if not is_copy(k.name))
            seg, seen_copy = [], True
        else:
            seg.append(o)
    return text, scan, rest


def vision_halves(ops: List[DeviceOp]) -> Tuple[list, list]:
    """``(b5, b6)``: the kernel groups of each fused block half found in
    launch order (see the module's docstring); an op sequence that does
    not match is skipped."""
    ks = kernels(ops)
    b5, b6 = [], []
    for j, o in enumerate(ks):
        if "attn_bf16" in o.name and 2 <= j < len(ks) - 1:
            grp = ks[j - 2:j + 2]
            if ("ln_bf16" in grp[0].name and gemm_act(grp[1].name) == 0
                    and gemm_act(grp[3].name) == 0):
                b5.append(grp)
        act = gemm_act(o.name)
        if act and 1 <= j < len(ks) - 1:
            grp = ks[j - 1:j + 2]
            if "ln_bf16" in grp[0].name and gemm_act(grp[2].name) == 0:
                b6.append(grp)
    return b5, b6


def upload_ops(ops: List[DeviceOp]) -> List[DeviceOp]:
    """Each host-to-device copy with the element-wise kernels that run
    right after it (the frames' cast and normalisation, the patch
    layout) before any other kernel."""
    out, follow = [], False
    for o in ops:
        if is_copy_htod(o.name):
            out.append(o)
            follow = True
        elif follow and "elementwise_kernel" in o.name \
                and "index" not in o.name:
            out.append(o)
        elif not is_copy(o.name):
            follow = False
    return out


def seconds(ops) -> float:
    return sum(o.dur_us for o in ops) / 1e6
