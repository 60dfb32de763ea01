"""The device JPEG programs against an independent float64 NumPy codec.

The reference below is written from the JPEG/JFIF definitions (orthonormal
8x8 DCT, libjpeg's triangular "fancy" 2x chroma upsample with edge
clamping at each image's own chroma extent, BT.601 colour), not from
ops/jpeg_decode.py or ops/jpeg_encode.py. The device programs run in
float32, so a sample may round the other way at a .5 boundary:
decoded pixels are held to 1 LSB, quantized coefficients to 1 step.
"""

import numpy as np
import pytest

from imageprocessor_tpu.ops.jpeg_decode import batched_decode_ycbcr
from imageprocessor_tpu.ops.jpeg_encode import (
    batched_encode_420,
    quality_qtables,
)
from imageprocessor_tpu.runtime.batcher import coef_canvas

# (fh, fw): chroma factors of 4:2:0, 4:2:2, 4:4:0, 4:4:4
MODES = {"420": (2, 2), "422": (1, 2), "440": (2, 1), "444": (1, 1)}


def dct_matrix() -> np.ndarray:
    """C[k, n] = c_k cos((2n+1) k pi / 16): coef = C x C^T."""
    k = np.arange(8)[:, None]
    n = np.arange(8)[None, :]
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))
    return c * np.cos((2 * n + 1) * k * np.pi / 16)


def idct_plane(coefs: np.ndarray, qt: np.ndarray) -> np.ndarray:
    c = dct_matrix()
    h, w = coefs.shape
    blocks = coefs.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    blocks = np.clip(blocks * qt, -4096, 4096)
    px = np.einsum("ki,abkl,lj->abij", c, blocks.astype(np.float64), c)
    return px.transpose(0, 2, 1, 3).reshape(h, w) + 128.0


def fancy_up2(p: np.ndarray, axis: int) -> np.ndarray:
    """libjpeg's triangular 2x upsample: 3/4 nearer + 1/4 farther."""
    n = p.shape[axis]
    prev = np.take(p, np.maximum(np.arange(n) - 1, 0), axis=axis)
    nxt = np.take(p, np.minimum(np.arange(n) + 1, n - 1), axis=axis)
    even, odd = 0.75 * p + 0.25 * prev, 0.75 * p + 0.25 * nxt
    return np.stack([even, odd], axis=axis + 1).reshape(
        p.shape[:axis] + (2 * n,) + p.shape[axis + 1:])


def decode_reference(y, cb, cr, qts, fh, fw, h, w):
    """One image's planes (own MCU grid) -> (h, w, 3) uint8."""
    yy = idct_plane(y, qts[0])
    chroma = []
    for plane, qt in ((cb, qts[1]), (cr, qts[2])):
        p = idct_plane(plane, qt)
        if fh > 1 or fw > 1:
            p = np.clip(p, 0, 255)     # libjpeg range-limits first
        if fh == 2:
            p = fancy_up2(p, 0)
        if fw == 2:
            p = fancy_up2(p, 1)
        chroma.append(p[:h, :w] - 128.0)
    yy = yy[:h, :w]
    cbf, crf = chroma
    rgb = np.stack([yy + 1.402 * crf,
                    yy - 0.344136 * cbf - 0.714136 * crf,
                    yy + 1.772 * cbf], -1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def random_planes(rng, h, w, fh, fw):
    """Plausible quantized coefficients: DC a smooth walk, AC sparse and
    decaying with frequency (as a real encoder leaves them)."""
    mh, mw = 8 * fh, 8 * fw
    ly, lx = -(-h // mh) * mh, -(-w // mw) * mw

    def plane(ph, pw, dc_scale):
        bh, bw = ph // 8, pw // 8
        out = np.zeros((bh, 8, bw, 8), np.int64)
        out[:, 0, :, 0] = np.cumsum(rng.integers(-3, 4, (bh, bw)), 1) \
            + rng.integers(-dc_scale, dc_scale, (bh, 1))
        freq = np.add.outer(np.arange(8), np.arange(8))
        ac = rng.integers(-12, 13, (bh, 8, bw, 8)) \
            * (rng.random((bh, 8, bw, 8)) < 0.3)
        ac = ac // (1 + freq[None, :, None, :])
        out = np.where(freq[None, :, None, :] == 0, out, ac)
        return out.reshape(ph, pw).astype(np.int16)

    return (plane(ly, lx, 40), plane(ly // fh, lx // fw, 10),
            plane(ly // fh, lx // fw, 10))


@pytest.mark.parametrize("quality", [60, 92])
@pytest.mark.parametrize("dims", [(64, 96), (53, 75)],
                         ids=["aligned", "unaligned"])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_matches_float64_reference(mode, dims, quality):
    fh, fw = MODES[mode]
    rng = np.random.default_rng([int(mode), dims[0], quality])
    bucket = (64, 96)
    ch, cw = coef_canvas(bucket, fh, fw)
    q = quality_qtables(quality).astype(np.float64)
    qts = np.stack([q[0], q[1], q[1]])
    shapes = [dims, (40, 56)]     # a second, smaller image in the batch
    yc = np.zeros((2, ch, cw), np.int16)
    cbc = np.zeros((2, ch // fh, cw // fw), np.int16)
    crc = np.zeros_like(cbc)
    cv = np.zeros((2, 2), np.int32)
    planes = []
    for i, (h, w) in enumerate(shapes):
        y, cb, cr = random_planes(rng, h, w, fh, fw)
        planes.append((y, cb, cr))
        yc[i, :y.shape[0], :y.shape[1]] = y
        cbc[i, :cb.shape[0], :cb.shape[1]] = cb
        crc[i, :cr.shape[0], :cr.shape[1]] = cr
        cv[i] = cb.shape
    out = np.asarray(batched_decode_ycbcr(
        yc, cbc, crc, np.stack([qts, qts]).astype(np.float32), cv,
        fh=fh, fw=fw, out_h=bucket[0], out_w=bucket[1]))
    assert out.shape == (2, *bucket, 3)
    for i, (h, w) in enumerate(shapes):
        want = decode_reference(*planes[i], qts, fh, fw, h, w)
        diff = np.abs(out[i, :h, :w].astype(np.int16) - want)
        assert diff.max() <= 1, (mode, i, diff.max())
        assert (diff > 0).mean() < 0.01


def encode_reference(rgb: np.ndarray, h: int, w: int, qt: np.ndarray):
    """(H, W, 3) canvas valid in [:h, :w] -> 4:2:0 quantized planes."""
    hh, ww = rgb.shape[:2]
    x = rgb.astype(np.float64)
    x = x[np.minimum(np.arange(hh), h - 1)][:, np.minimum(np.arange(ww),
                                                          w - 1)]
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0

    def down2(p):
        return p.reshape(hh // 2, 2, ww // 2, 2).mean(axis=(1, 3))

    def fdct(p, q):
        c = dct_matrix()
        ph, pw = p.shape
        blocks = (p - 128.0).reshape(ph // 8, 8, pw // 8, 8)
        coef = np.einsum("ki,aibj,lj->akbl", c, blocks, c)
        coef = np.clip(np.round(coef / q[None, :, None, :]), -1023, 1023)
        return coef.reshape(ph, pw)

    return fdct(y, qt[0]), fdct(down2(cb), qt[1]), fdct(down2(cr), qt[1])


@pytest.mark.parametrize("quality", [60, 92])
@pytest.mark.parametrize("dims", [(64, 96), (53, 75)],
                         ids=["aligned", "unaligned"])
def test_encode_matches_float64_reference(dims, quality):
    rng = np.random.default_rng(quality + dims[0])
    h, w = dims
    canvas = np.zeros((2, 64, 96, 3), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(2):
        smooth = np.stack([yy * 2 + xx, 255 - xx * 2, (yy + xx) % 256], -1)
        canvas[i, :h, :w] = np.clip(smooth + rng.normal(0, 8, (h, w, 3)),
                                    0, 255).astype(np.uint8)
    qt = quality_qtables(quality).astype(np.float32)
    vh = np.asarray([[h, w]] * 2, np.int32)
    got = [np.asarray(p) for p in batched_encode_420(canvas, vh, qt)]
    for i in range(2):
        want = encode_reference(canvas[i], h, w, qt.astype(np.float64))
        for g, r in zip(got, want):
            diff = np.abs(g[i].astype(np.int32) - r)
            assert diff.max() <= 1
            assert (diff > 0).mean() < 0.001
