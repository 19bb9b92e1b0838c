"""Port recall evaluation (video_quierer_tpu_torch/evaluation.py, CPU
device) vs the JAX package's ``evaluation.py``: the same ground-truth ids
(the exact f32 scan, rows equal), the same recall@k with pads on both
sides, and the same ``evaluate_modes`` report (exact equality: recall is
a ratio of counts).
"""

import numpy as np

from tests.torch_parity import unit_rows
from video_quierer_tpu import evaluation as jax_eval
from video_quierer_tpu_torch import evaluation as torch_eval


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 50, (6, 10))
    got = rng.integers(-1, 50, (6, 10))
    truth[0, 7:] = 2**31 - 1                  # the scan's pad sentinel
    got[1, :] = -1                            # nothing returned
    assert torch_eval.recall_at_k(truth, got) == \
        jax_eval.recall_at_k(truth, got)
    empty = np.full((2, 3), 2**31 - 1)
    assert torch_eval.recall_at_k(empty, got[:2, :3]) == 1.0 == \
        jax_eval.recall_at_k(empty, got[:2, :3])


def test_exact_ids_and_evaluate_modes_match_jax():
    rng = np.random.default_rng(1)
    emb = unit_rows(rng, 3000, 64)
    q = unit_rows(rng, 5, 64)
    want = jax_eval.exact_topk_ids(emb, q, 10)
    got = torch_eval.exact_topk_ids(emb, q, 10, device="cpu")
    np.testing.assert_array_equal(got, want)
    # k past the corpus: pads on the truth side
    np.testing.assert_array_equal(
        torch_eval.exact_topk_ids(emb[:7], q, 10, device="cpu"),
        jax_eval.exact_topk_ids(emb[:7], q, 10))
    searchers = {
        "exact": lambda qs, k: (emb @ qs.T).T.argsort(axis=1)[:, ::-1][:, :k],
        "half": lambda qs, k: np.where(np.arange(k) < k // 2,
                                       want[:, :k], -1),
    }
    report = torch_eval.evaluate_modes(emb, q, 10, searchers, device="cpu")
    assert report == jax_eval.evaluate_modes(emb, q, 10, searchers)
    assert report == {"exact": 1.0, "half": 0.5}
