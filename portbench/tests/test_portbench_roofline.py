"""The frozen counts against hand counts."""

import json

import pytest

from portbench import roofline
from portbench.tests.tiny import ROOT


@pytest.fixture(scope="module")
def b32():
    return json.loads((ROOT / "portbench" / "configs"
                       / "clip-vit-b-32.json").read_text())


def test_vit_b32_frame(b32):
    # patches 2*49*3072*768; a block 8*50*768^2 + 4*50^2*768
    # + 4*50*768*3072; twelve blocks; the projection 2*768*512
    block = 235_929_600 + 7_680_000 + 471_859_200
    assert roofline.vision_flops(b32) == 231_211_008 + 12 * block + 786_432
    assert roofline.vision_flops(b32) == 8_817_623_040


def test_text_query(b32):
    # 7 tokens: 12 blocks of 8*7*512^2 + 4*49*512 + 4*7*512*2048
    block = 14_680_064 + 100_352 + 29_360_128
    assert roofline.text_flops(b32, 7) == 12 * block + 2 * 512 * 512


def test_b1_scan():
    nbytes, ops = roofline.scan_pass(2_000_000, 512, 64)
    winners = 2 * 1954 * 64 * 8
    assert nbytes == 2_000_000 * 512 * 2 + 64 * 512 * 4 + winners
    assert ops == 2 * 2_000_000 * 512 * 64
    # byte-bound: 2.05 GB at 3.35 TB/s
    assert roofline.bound_s(nbytes, ops, "bf16") == pytest.approx(
        nbytes / 3.35e12)
    assert 0.60e-3 < roofline.bound_s(nbytes, ops, "bf16") < 0.62e-3


def test_halves():
    t, d, f, s = 256 * 50, 768, 3072, 50
    nb, ops = roofline.attn_half(t, d, s)
    assert ops == 8 * t * d * d + 4 * t * s * d
    assert nb == 4 * t * d + 2 * (4 * d * d + 4 * d) + 16 * d
    nb, ops = roofline.mlp_half(t, d, f)
    assert ops == 4 * t * f * d
    assert nb == 4 * t * d + 2 * (2 * d * f + f + d) + 16 * d


def test_train_pair(b32):
    assert roofline.train_flops(b32, 77) == 3 * (
        roofline.vision_flops(b32) + roofline.text_flops(b32, 77))
    # ~11.4 TFLOP a step of 256 pairs at 77 tokens
    assert 11.0e12 < 256 * roofline.train_flops(b32, 77) < 11.8e12
