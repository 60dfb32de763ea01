"""Watermark golden tests (round-1 weak item #6).

Two layers:

1. Committed-render regression goldens (always run): the full watermark
   op — FreeType raster, anchor math (watermark.go:121-148), alpha blend
   (watermark.go:151) — against byte-committed outputs, pinned to the
   DejaVu fallback font so any drift in rasterization, anchoring, or
   blend arithmetic fails loudly.

2. Go-Regular glyph parity (gated): the reference embeds Go-Regular
   (watermark.go:29-38). This build environment has no copy of that TTF
   and no egress to fetch one, so the pixel-level comparison against a
   Go-stack render runs only when a deployment provides both artifacts:

   * ``imageprocessor_tpu/assets/fonts/Go-Regular.ttf`` (or the
     ``IMAGEPROCESSOR_FONT`` env var) — the font itself, and
   * ``tests/golden/watermark_goregular_ref.npy`` — a render produced by
     the reference Go code on the committed background
     (``tests/golden/watermark_bg.npy``) with default params; the
     generation recipe is documented in PARITY.md.

   When both exist the test asserts PSNR > 45 dB (BASELINE contract).
"""

import os

import numpy as np
import pytest

from imageprocessor_tpu.ops import watermark as wm

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")


def _dejavu() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(wm.__file__)),
                        os.pardir, "assets", "fonts", "DejaVuSans.ttf")


def _bg() -> np.ndarray:
    return np.load(os.path.join(GOLDEN, "watermark_bg.npy"))


@pytest.mark.parametrize("pos", ["bottom-right", "top-left", "center"])
def test_watermark_matches_committed_golden(pos):
    got = np.asarray(wm.watermark_image(_bg(), position=pos,
                                        font_path=_dejavu()))
    want = np.load(os.path.join(GOLDEN, f"watermark_{pos}.npy"))
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    # CPU backend is deterministic; ±1 LSB headroom for XLA version drift
    assert diff.max() <= 1, f"max diff {diff.max()}"
    assert (diff > 0).mean() < 1e-3


def test_golden_actually_contains_text():
    """Guard against a silently-blank golden (e.g. zero-coverage tile)."""
    bg = _bg()
    want = np.load(os.path.join(GOLDEN, "watermark_bottom-right.npy"))
    changed = (want != bg).any(axis=-1)
    assert 2000 < changed.sum() < bg.shape[0] * bg.shape[1] * 0.2
    ys, xs = np.where(changed)
    # bottom-right anchor, 20 px margin (watermark.go:121-148)
    assert ys.min() > bg.shape[0] * 0.5
    assert xs.max() >= bg.shape[1] - 21


def test_font_env_override_changes_raster(monkeypatch):
    """IMAGEPROCESSOR_FONT redirects the default font (the Go-Regular
    drop-in mechanism); the cache key includes the path."""
    bold = _dejavu().replace("DejaVuSans.ttf", "DejaVuSans-Bold.ttf")
    if not os.path.exists(bold):
        pytest.skip("no second font available")
    monkeypatch.setenv("IMAGEPROCESSOR_FONT", bold)
    monkeypatch.setattr(wm, "_DEFAULT_FONT_PATH", None)
    t_bold = wm.rasterize_text("Wm parity", 36.0)
    t_reg = wm.rasterize_text("Wm parity", 36.0, font_path=_dejavu())
    assert t_bold.width_px > t_reg.width_px  # bold advances are wider


def _goregular_path() -> str | None:
    env = os.environ.get("IMAGEPROCESSOR_FONT", "")
    if env and "go" in os.path.basename(env).lower():
        return env
    pkg = os.path.join(HERE, "..", "imageprocessor_tpu", "assets", "fonts")
    for name in ("Go-Regular.ttf", "GoRegular.ttf", "goregular.ttf"):
        cand = os.path.abspath(os.path.join(pkg, name))
        if os.path.exists(cand):
            return cand
    return None


def test_goregular_glyph_parity_vs_go_render():
    font = _goregular_path()
    ref_path = os.path.join(GOLDEN, "watermark_goregular_ref.npy")
    if font is None:
        pytest.skip("Go-Regular.ttf not provided (no copy in this "
                    "environment, no egress); see PARITY.md for the "
                    "drop-in recipe")
    if not os.path.exists(ref_path):
        pytest.skip("no Go-stack reference render committed; see "
                    "PARITY.md for the generation recipe")
    import sys

    sys.path.insert(0, HERE)
    from oracle import psnr

    got = np.asarray(wm.watermark_image(_bg(), font_path=font))
    want = np.load(ref_path)
    assert psnr(got, want) > 45.0
