"""ctypes bindings for the native host codec (native/*.cpp).

The library is the framework's C++ host-runtime component. Two parts:

* libjpeg-free: the streaming entropy scanner and emitter
  (jpeg_scan.cpp, jpeg_emit.cpp) that the device-JPEG route and the
  splice/coefficient transforms need, the GIF quantizer, and small
  helpers (iputil.cpp);
* libjpeg(-turbo) (ipcodec.cpp): decode/encode with DCT-domain scaled
  decode, coefficient reads and header-only probing.

Loading is lazy: if the shared library is absent it is built on demand
with g++. A host without libjpeg's headers gets the libjpeg-free part
only (`available()` is True, `has_libjpeg()` False); the libjpeg entry
points then raise NativeCodecError and callers fall back to the
OpenCV/PIL path in runtime/codecs.py.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
_SRC = _REPO_ROOT / "native" / "ipcodec.cpp"
_SRC_SCAN = _REPO_ROOT / "native" / "jpeg_scan.cpp"
_SRC_EMIT = _REPO_ROOT / "native" / "jpeg_emit.cpp"
_SRC_GIF = _REPO_ROOT / "native" / "gifquant.cpp"
_SRC_UTIL = _REPO_ROOT / "native" / "iputil.cpp"
# Sources that need no codec library; ipcodec.cpp (libjpeg) joins them
# when the host has libjpeg's headers.
_SRCS_BASE = (_SRC_SCAN, _SRC_EMIT, _SRC_GIF, _SRC_UTIL)
_LIB = _REPO_ROOT / "native" / "libipcodec.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False


class NativeCodecError(RuntimeError):
    pass


def _build() -> bool:
    base = [str(src) for src in _SRCS_BASE]
    # Built on the machine that runs it, so -march=native is safe and
    # worth ~15% on the entropy decoder; fall back to plain -O3 for
    # compilers/arches that reject it, and to the libjpeg-free sources
    # when libjpeg's headers or library are missing.
    # Compile to a per-process temp name, then atomically rename into
    # place: concurrent worker processes cold-starting together must
    # never dlopen a half-written .so.
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp.so")
    attempts = [([str(_SRC), *base], arch, ["-ljpeg"])
                for arch in (["-march=native"], [])]
    attempts += [(base, arch, []) for arch in (["-march=native"], [])]
    for srcs, arch, libs in attempts:
        try:
            subprocess.run(
                ["g++", "-O3", *arch, "-shared", "-fPIC", "-pthread",
                 *srcs, "-o", str(tmp), *libs],
                check=True, capture_output=True, timeout=180)
            os.replace(tmp, _LIB)
            return True
        except (subprocess.SubprocessError, OSError):
            continue
        finally:
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
    return False


def _stale() -> bool:
    """True when any native source is newer than the built library."""
    try:
        lib_m = _LIB.stat().st_mtime
        return any(s.exists() and s.stat().st_mtime > lib_m
                   for s in (_SRC, *_SRCS_BASE))
    except OSError:
        return True


def _load() -> ctypes.CDLL | None:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        if not _LIB.exists() or _stale():
            if not _build() and not _LIB.exists():
                _load_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            # A library built on another host (e.g. linked against a
            # libjpeg this one lacks): rebuild here once, then retry.
            try:
                if not _build():
                    raise OSError("native build failed")
                lib = ctypes.CDLL(str(_LIB))
            except OSError:
                _load_failed = True
                return None
        try:
            _set_scan_argtypes(lib)
        except AttributeError:
            # Stale .so missing the scanner entry points and the rebuild
            # above failed: treat the library as unavailable so
            # available() returns False and callers degrade to the
            # generic codec path.
            _load_failed = True
            return None
        if hasattr(lib, "ip_jpeg_probe"):
            _set_libjpeg_argtypes(lib)
        try:
            lib.ip_jpeg_emit_strided_ilp.argtypes = (
                lib.ip_jpeg_emit_strided.argtypes + [ctypes.c_int])
            lib.ip_jpeg_emit_strided_ilp.restype = ctypes.c_long
        except AttributeError:  # pragma: no cover — stale .so
            pass
        try:
            lib.ip_jpeg_scan_coefs_offsets.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
            lib.ip_jpeg_scan_coefs_offsets.restype = ctypes.c_int
            lib.ip_jpeg_scan_tables.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int),
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.ip_jpeg_scan_tables.restype = ctypes.c_int
            lib.ip_jpeg_emit_transcode.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t]
            lib.ip_jpeg_emit_transcode.restype = ctypes.c_long
        except AttributeError:  # pragma: no cover — stale .so
            pass
        try:
            lib.ip_jpeg_scan_coefs_offsets_rst.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_void_p]
            lib.ip_jpeg_scan_coefs_offsets_rst.restype = ctypes.c_int
            lib.ip_jpeg_emit_transcode_rst.argtypes = (
                lib.ip_jpeg_emit_transcode.argtypes
                + [ctypes.c_int, ctypes.c_void_p])
            lib.ip_jpeg_emit_transcode_rst.restype = ctypes.c_long
        except AttributeError:  # pragma: no cover — stale .so
            pass
        try:
            lib.ip_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_uint32]
            lib.ip_crc32c.restype = ctypes.c_uint32
        except AttributeError:  # pragma: no cover — stale .so
            pass
        try:
            lib.ip_gif_quantize_plan9.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_long, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.ip_gif_quantize_plan9.restype = ctypes.c_int
        except AttributeError:  # pragma: no cover — stale .so
            pass
        lib.ip_free.argtypes = [ctypes.c_void_p]
        lib.ip_free.restype = None
        _lib = lib
        return _lib


def _set_scan_argtypes(lib: ctypes.CDLL) -> None:
    """Signatures of the libjpeg-free core every usable build exposes;
    raises AttributeError on a stale build."""
    lib.ip_jpeg_scan_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ip_jpeg_scan_dims.restype = ctypes.c_int
    lib.ip_jpeg_scan_coefs.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ip_jpeg_scan_coefs.restype = ctypes.c_int
    lib.ip_jpeg_scan_coefs_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ip_jpeg_scan_coefs_mt.restype = ctypes.c_int
    lib.ip_jpeg_scan_qtabs.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
    lib.ip_jpeg_scan_qtabs.restype = ctypes.c_int
    lib.ip_jpeg_emit.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_size_t]
    lib.ip_jpeg_emit.restype = ctypes.c_long
    lib.ip_jpeg_emit_strided.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_size_t]
    lib.ip_jpeg_emit_strided.restype = ctypes.c_long
    lib.ip_free.argtypes = [ctypes.c_void_p]
    lib.ip_free.restype = None


def _set_libjpeg_argtypes(lib: ctypes.CDLL) -> None:
    """Signatures of the libjpeg part (ipcodec.cpp)."""
    lib.ip_jpeg_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ip_jpeg_probe.restype = ctypes.c_int
    lib.ip_jpeg_scaled_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.ip_jpeg_scaled_dims.restype = ctypes.c_int
    lib.ip_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int]
    lib.ip_jpeg_decode.restype = ctypes.c_int
    lib.ip_jpeg_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t)]
    lib.ip_jpeg_encode.restype = ctypes.c_int
    lib.ip_jpeg_coef_dims.argtypes = lib.ip_jpeg_scan_dims.argtypes
    lib.ip_jpeg_coef_dims.restype = ctypes.c_int
    lib.ip_jpeg_read_coefs.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.ip_jpeg_read_coefs.restype = ctypes.c_int


def available() -> bool:
    """True when the libjpeg-free core (entropy scan/emit) loaded."""
    return _load() is not None


def has_libjpeg() -> bool:
    """True when the library also carries the libjpeg part."""
    lib = _load()
    return lib is not None and hasattr(lib, "ip_jpeg_probe")


def _libjpeg() -> ctypes.CDLL:
    lib = _load()
    if lib is None or not hasattr(lib, "ip_jpeg_probe"):
        raise NativeCodecError("native libjpeg codec unavailable")
    return lib


def probe_jpeg(data: bytes) -> tuple[int, int, int]:
    """(width, height, components) from the header, no entropy decode."""
    lib = _libjpeg()
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.ip_jpeg_probe(data, len(data), ctypes.byref(w),
                           ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        raise NativeCodecError(f"probe failed (rc={rc})")
    return w.value, h.value, c.value


def decode_jpeg(data: bytes, scale_num: int = 8) -> np.ndarray:
    """Decode to (H, W, 3) uint8 RGB at scale scale_num/8 (1..8).

    scale_num < 8 performs the downscale in the DCT domain — for a
    thumbnail-only task, decoding at 1/4 scale costs roughly 1/10th of a
    full 12 MP decode.
    """
    if not 1 <= scale_num <= 8:
        raise ValueError("scale_num must be in 1..8")
    lib = _libjpeg()
    ow = ctypes.c_int()
    oh = ctypes.c_int()
    rc = lib.ip_jpeg_scaled_dims(data, len(data), scale_num,
                                 ctypes.byref(ow), ctypes.byref(oh))
    if rc != 0:
        raise NativeCodecError(f"bad jpeg (rc={rc})")
    out = np.empty((oh.value, ow.value, 3), dtype=np.uint8)
    rc = lib.ip_jpeg_decode(data, len(data), scale_num,
                            out.ctypes.data_as(ctypes.c_void_p),
                            out.strides[0])
    if rc != 0:
        raise NativeCodecError(f"decode failed (rc={rc})")
    return out


# Decompression-bomb gate for the coefficient paths: plane allocation is
# sized from HEADER-claimed dims, so a few-hundred-byte crafted JPEG
# claiming 65500x65500 would demand ~25 GB before any bucket/size check
# runs. 100 MP comfortably covers every real upload (the generic
# decoder's own PIL bomb guard sits at a similar scale); beyond it the
# caller falls back to the generic path, which raises safely.
_MAX_COEF_PIXELS = 100_000_000


def _check_coef_dims(iw: int, ih: int) -> None:
    if iw * ih > _MAX_COEF_PIXELS:
        raise NativeCodecError(
            f"header claims {iw}x{ih} ({iw * ih / 1e6:.0f} MP) — over the "
            f"{_MAX_COEF_PIXELS / 1e6:.0f} MP coefficient-path cap")

def read_jpeg_coefficients(data: bytes):
    """Entropy-decode ONLY: quantized DCT coefficient planes + quant tables.

    This is the host side of device-side JPEG decode — the sequential Huffman
    pass stays here (~1/3 of a full decode), while dequant + iDCT +
    upsample + color conversion run on the accelerator
    (ops/jpeg_decode.py). Returns (planes, qtabs, (img_w, img_h), sampling)
    where planes[c] is int16 (blocks_h*8, blocks_w*8) with each 8x8 block
    at its spatial position, and qtabs is (ncomp, 8, 8) float32.
    """
    lib = _libjpeg()
    ncomp = ctypes.c_int()
    iw = ctypes.c_int()
    ih = ctypes.c_int()
    cbw = (ctypes.c_int * 4)()
    cbh = (ctypes.c_int * 4)()
    hs = (ctypes.c_int * 4)()
    vs = (ctypes.c_int * 4)()
    rc = lib.ip_jpeg_coef_dims(data, len(data), ctypes.byref(ncomp),
                               ctypes.byref(iw), ctypes.byref(ih),
                               cbw, cbh, hs, vs)
    if rc != 0:
        raise NativeCodecError(f"coef dims failed (rc={rc})")
    _check_coef_dims(iw.value, ih.value)
    n = ncomp.value
    if n not in (1, 3):
        raise NativeCodecError(f"unsupported component count {n}")
    planes = [np.zeros((cbh[c] * 8, cbw[c] * 8), dtype=np.int16)
              for c in range(n)]
    while len(planes) < 3:
        planes.append(np.zeros((8, 8), dtype=np.int16))
    qt = np.zeros((3, 64), dtype=np.uint16)
    rc = lib.ip_jpeg_read_coefs(
        data, len(data),
        planes[0].ctypes.data_as(ctypes.c_void_p),
        planes[1].ctypes.data_as(ctypes.c_void_p),
        planes[2].ctypes.data_as(ctypes.c_void_p),
        qt.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise NativeCodecError(f"read coefs failed (rc={rc})")
    sampling = [(hs[c], vs[c]) for c in range(n)]
    return (planes[:n], qt[:n].reshape(n, 8, 8).astype(np.float32),
            (iw.value, ih.value), sampling)


def scan_jpeg_coefficients(data: bytes, threads: int = 0):
    """Streaming entropy decode (native/jpeg_scan.cpp): ONE pass, no
    intermediate buffering — the fast host half of device-side JPEG decode.

    Returns (planes, qtabs, (img_w, img_h), sampling) like
    read_jpeg_coefficients, except plane dims are MCU-aligned (>= the
    libjpeg block grid; extra blocks hold the encoder's edge padding).
    Raises NativeCodecError for non-baseline streams (progressive etc.) —
    callers fall back to read_jpeg_coefficients/libjpeg.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "ip_jpeg_scan_dims"):
        raise NativeCodecError("streaming scanner unavailable")
    ncomp = ctypes.c_int()
    iw = ctypes.c_int()
    ih = ctypes.c_int()
    cbw = (ctypes.c_int * 4)()
    cbh = (ctypes.c_int * 4)()
    hs = (ctypes.c_int * 4)()
    vs = (ctypes.c_int * 4)()
    rc = lib.ip_jpeg_scan_dims(data, len(data), ctypes.byref(ncomp),
                               ctypes.byref(iw), ctypes.byref(ih),
                               cbw, cbh, hs, vs)
    if rc != 0:
        raise NativeCodecError(f"scan dims failed (rc={rc})")
    _check_coef_dims(iw.value, ih.value)
    n = ncomp.value
    planes = [np.zeros((cbh[c] * 8, cbw[c] * 8), dtype=np.int16)
              for c in range(n)]
    while len(planes) < 3:
        planes.append(np.zeros((8, 8), dtype=np.int16))
    if threads and threads > 1:
        # Streams with restart markers decode their segments in
        # parallel; others transparently use the sequential path.
        rc = lib.ip_jpeg_scan_coefs_mt(
            data, len(data), int(threads),
            planes[0].ctypes.data_as(ctypes.c_void_p),
            planes[1].ctypes.data_as(ctypes.c_void_p),
            planes[2].ctypes.data_as(ctypes.c_void_p))
    else:
        rc = lib.ip_jpeg_scan_coefs(
            data, len(data),
            planes[0].ctypes.data_as(ctypes.c_void_p),
            planes[1].ctypes.data_as(ctypes.c_void_p),
            planes[2].ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise NativeCodecError(f"scan coefs failed (rc={rc})")
    qt = np.zeros((3, 64), dtype=np.uint16)
    rc = lib.ip_jpeg_scan_qtabs(data, len(data),
                                qt.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise NativeCodecError(f"scan qtabs failed (rc={rc})")
    sampling = [(hs[c], vs[c]) for c in range(n)]
    return (planes[:n], qt[:n].reshape(n, 8, 8).astype(np.float32),
            (iw.value, ih.value), sampling)


def emit_jpeg_from_coefficients(planes, qtabs, img_w: int, img_h: int,
                                sampling=(2, 2),
                                restart_interval: int = 0,
                                interleave: int = 1) -> bytes:
    """Entropy-encode quantized coefficient planes into a baseline JFIF
    stream (native/jpeg_emit.cpp, Annex K Huffman tables) — the host
    half of device-side JPEG encode.

    planes: 1 or 3 int16 arrays in natural order, spatial block layout,
    MCU-aligned dims (luma (ceil(h/8v0)*8v0, ceil(w/8h0)*8h0); chroma
    divided by the sampling factors). qtabs: (ncomp, 8, 8) or (ncomp, 64)
    quant tables in natural order (chroma components share qtabs[1]).
    sampling: luma (h0, v0); chroma is always 1x1. restart_interval > 0
    emits DRI + RSTn markers every that many MCUs, which lets decoders
    (including scan_jpeg_coefficients) split the entropy pass across
    cores.

    interleave > 1 (needs restart_interval > 0) encodes that many
    restart segments concurrently on ONE core with independent bit
    chains; output is byte-identical to the sequential path. Opt-in:
    measured on the round-4 dev Xeon it is throughput-NEUTRAL to
    slightly negative (the emit loop is issue-bound, not latency-bound
    there — see PERF.md); kept for wider production cores to A/B.
    """
    lib = _load()
    # Guard on the symbol actually called below — a stale library built
    # from older sources may expose ip_jpeg_emit but not the strided
    # entry point, and an AttributeError here would bypass callers'
    # NativeCodecError fallbacks.
    if lib is None or not hasattr(lib, "ip_jpeg_emit_strided"):
        raise NativeCodecError("native emitter unavailable")
    ncomp = len(planes)
    if ncomp not in (1, 3):
        raise NativeCodecError(f"ncomp must be 1 or 3, got {ncomp}")
    # Row-strided 2-D views (e.g. per-image slices of a batch canvas)
    # are passed through without copying; only the row-interior must be
    # contiguous.
    arrs = []
    for p in planes:
        a = np.asarray(p)
        if (a.dtype != np.int16 or a.ndim != 2
                or a.strides[1] != a.itemsize):
            a = np.ascontiguousarray(a, dtype=np.int16)
        arrs.append(a)
    while len(arrs) < 3:
        arrs.append(np.zeros((8, 8), dtype=np.int16))
    qt = np.ascontiguousarray(np.asarray(qtabs), dtype=np.uint16)
    qt = qt.reshape(qt.shape[0], 64)
    qt2 = np.zeros((2, 64), dtype=np.uint16)
    qt2[0] = qt[0]
    qt2[1] = qt[1] if qt.shape[0] > 1 else qt[0]
    # The emitter writes 8-bit (pq=0) DQT segments; a 16-bit table value
    # would be silently clamped to 255 and every decoder would then
    # dequantize with the wrong step — reject instead of corrupting.
    if qt2.max() > 255 or qt2.min() < 1:
        raise NativeCodecError(
            "quant table values must be in 1..255 (8-bit DQT); got "
            f"range {int(qt2.min())}..{int(qt2.max())}")
    h0, v0 = (int(sampling[0]), int(sampling[1])) if ncomp == 3 else (1, 1)
    # The native emitter trusts plane dims; reject undersized planes
    # here so a caller bug can't turn into an out-of-bounds read.
    mcus_x = -(-int(img_w) // (h0 * 8))
    mcus_y = -(-int(img_h) // (v0 * 8))
    for c in range(ncomp):
        need = ((mcus_y * (v0 if c == 0 else 1)) * 8,
                (mcus_x * (h0 if c == 0 else 1)) * 8)
        # Width must match exactly (the emitter derives the row stride
        # from the MCU grid); extra rows beyond the grid are ignored.
        if arrs[c].shape[0] < need[0] or arrs[c].shape[1] != need[1]:
            raise NativeCodecError(
                f"component {c} plane {arrs[c].shape} does not match the "
                f"MCU-aligned grid {need} for {img_w}x{img_h}")
    # Worst case ~2 bytes/coefficient + headers; coefficient data is
    # bounded well under that in practice.
    cap = sum(a.size for a in arrs[:ncomp]) * 2 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    strides = [a.strides[0] // a.itemsize for a in arrs]
    if (int(interleave) > 1 and int(restart_interval) > 0
            and hasattr(lib, "ip_jpeg_emit_strided_ilp")):
        n = lib.ip_jpeg_emit_strided_ilp(
            arrs[0].ctypes.data_as(ctypes.c_void_p),
            arrs[1].ctypes.data_as(ctypes.c_void_p),
            arrs[2].ctypes.data_as(ctypes.c_void_p),
            qt2.ctypes.data_as(ctypes.c_void_p),
            img_w, img_h, ncomp, h0, v0, int(restart_interval),
            strides[0], strides[1], strides[2],
            out.ctypes.data_as(ctypes.c_void_p), cap, int(interleave))
    else:
        n = lib.ip_jpeg_emit_strided(
            arrs[0].ctypes.data_as(ctypes.c_void_p),
            arrs[1].ctypes.data_as(ctypes.c_void_p),
            arrs[2].ctypes.data_as(ctypes.c_void_p),
            qt2.ctypes.data_as(ctypes.c_void_p),
            img_w, img_h, ncomp, h0, v0, int(restart_interval),
            strides[0], strides[1], strides[2],
            out.ctypes.data_as(ctypes.c_void_p), cap)
    if n < 0:
        raise NativeCodecError(f"jpeg emit failed (rc={n})")
    return out[:n].tobytes()


class JpegSpliceContext:
    """Everything ip_jpeg_emit_transcode needs to splice-edit one JPEG:
    coefficient planes, the destuffed entropy stream with per-MCU bit
    offsets, and the input's own table assignments. Produced by
    scan_jpeg_for_transcode; consumed by emit_jpeg_transcode after the
    caller edits `planes` in place and flags the touched MCUs."""

    __slots__ = ("planes", "qt_slots", "qtabs", "size", "sampling",
                 "destuff", "mcu_bits", "destuff_bits", "comp_id",
                 "comp_tq", "comp_dc", "comp_ac", "dht_bits", "dht_vals",
                 "dht_present", "mcus_x", "mcus_y", "edited",
                 "restart_interval", "seg_bits", "undo")

    @property
    def nmcus(self) -> int:
        return self.mcus_x * self.mcus_y


def scan_jpeg_for_transcode(data: bytes) -> JpegSpliceContext:
    """Streaming entropy decode PLUS splice support: per-MCU bit offsets
    into a destuffed copy of the entropy stream, and the input's own
    Huffman/quant table specs. Restart-marker streams are supported
    (segment end bits recorded; the splice emitter re-declares DRI and
    preserves every boundary 1:1). Raises NativeCodecError for anything
    the splice emitter cannot reproduce (progressive, truncated
    streams) — callers fall back to the full re-encode path.
    """
    lib = _load()
    if (lib is None
            or not hasattr(lib, "ip_jpeg_scan_coefs_offsets_rst")
            or not hasattr(lib, "ip_jpeg_emit_transcode_rst")):
        raise NativeCodecError("splice scanner unavailable")
    ncomp = ctypes.c_int()
    iw = ctypes.c_int()
    ih = ctypes.c_int()
    cbw = (ctypes.c_int * 4)()
    cbh = (ctypes.c_int * 4)()
    hs = (ctypes.c_int * 4)()
    vs = (ctypes.c_int * 4)()
    rc = lib.ip_jpeg_scan_dims(data, len(data), ctypes.byref(ncomp),
                               ctypes.byref(iw), ctypes.byref(ih),
                               cbw, cbh, hs, vs)
    if rc != 0:
        raise NativeCodecError(f"scan dims failed (rc={rc})")
    _check_coef_dims(iw.value, ih.value)
    n = ncomp.value
    if n not in (1, 3):
        raise NativeCodecError(f"unsupported component count {n}")
    planes = [np.zeros((cbh[c] * 8, cbw[c] * 8), dtype=np.int16)
              for c in range(n)]
    pv = planes + [np.zeros((8, 8), dtype=np.int16)] * (3 - n)
    hmax = max(hs[c] for c in range(n)) if n == 3 else 1
    vmax = max(vs[c] for c in range(n)) if n == 3 else 1
    mcus_x = -(-iw.value // (hmax * 8))
    mcus_y = -(-ih.value // (vmax * 8))
    nmcus = mcus_x * mcus_y
    # Tables first (cheap header parse): the restart interval sizes the
    # destuff buffer and the per-segment end array.
    comp_id = np.zeros(3, dtype=np.uint8)
    comp_tq = np.zeros(3, dtype=np.uint8)
    comp_dc = np.zeros(3, dtype=np.uint8)
    comp_ac = np.zeros(3, dtype=np.uint8)
    dht_bits = np.zeros((8, 17), dtype=np.uint8)
    dht_vals = np.zeros((8, 256), dtype=np.uint8)
    dht_present = np.zeros(8, dtype=np.uint8)
    qt = np.zeros((4, 64), dtype=np.uint16)
    nc2 = ctypes.c_int()
    dri = ctypes.c_int()
    prog = ctypes.c_int()
    rc = lib.ip_jpeg_scan_tables(
        data, len(data), ctypes.byref(nc2),
        comp_id.ctypes.data_as(ctypes.c_void_p),
        comp_tq.ctypes.data_as(ctypes.c_void_p),
        comp_dc.ctypes.data_as(ctypes.c_void_p),
        comp_ac.ctypes.data_as(ctypes.c_void_p),
        dht_bits.ctypes.data_as(ctypes.c_void_p),
        dht_vals.ctypes.data_as(ctypes.c_void_p),
        dht_present.ctypes.data_as(ctypes.c_void_p),
        qt.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(dri), ctypes.byref(prog))
    if rc != 0:
        raise NativeCodecError(f"scan tables failed (rc={rc})")
    ri = int(dri.value)
    nseg = -(-nmcus // ri) if ri > 0 else 1
    # +64: the scanner may append a few synthetic zero-fill bytes at the
    # stream tail and the splice emitter bulk-reads 8-byte windows;
    # each restart boundary can append up to 8 more.
    destuff = np.zeros(len(data) + 64 + 8 * (nseg - 1), dtype=np.uint8)
    mcu_bits = np.zeros(nmcus + 1, dtype=np.int64)
    seg_bits = (np.zeros(max(nseg - 1, 1), dtype=np.int64)
                if ri > 0 else None)
    dbits = ctypes.c_int64()
    rc = lib.ip_jpeg_scan_coefs_offsets_rst(
        data, len(data),
        pv[0].ctypes.data_as(ctypes.c_void_p),
        pv[1].ctypes.data_as(ctypes.c_void_p),
        pv[2].ctypes.data_as(ctypes.c_void_p),
        destuff.ctypes.data_as(ctypes.c_void_p), destuff.size,
        mcu_bits.ctypes.data_as(ctypes.c_void_p), ctypes.byref(dbits),
        seg_bits.ctypes.data_as(ctypes.c_void_p)
        if seg_bits is not None else None)
    if rc != 0:
        raise NativeCodecError(f"splice scan failed (rc={rc})")
    if mcu_bits[nmcus] > dbits.value:
        raise NativeCodecError("truncated entropy stream")
    ctx = JpegSpliceContext()
    ctx.planes = planes
    ctx.qt_slots = qt
    ctx.qtabs = np.stack([qt[comp_tq[c]] for c in range(n)]
                         ).reshape(n, 8, 8).astype(np.float32)
    ctx.size = (iw.value, ih.value)
    ctx.sampling = [(hs[c], vs[c]) for c in range(n)]
    ctx.destuff = destuff
    ctx.mcu_bits = mcu_bits
    ctx.destuff_bits = int(dbits.value)
    ctx.comp_id = comp_id
    ctx.comp_tq = comp_tq
    ctx.comp_dc = comp_dc
    ctx.comp_ac = comp_ac
    ctx.dht_bits = dht_bits
    ctx.dht_vals = dht_vals
    ctx.dht_present = dht_present
    ctx.mcus_x = mcus_x
    ctx.mcus_y = mcus_y
    ctx.restart_interval = ri
    ctx.seg_bits = seg_bits if ri > 0 else None
    ctx.edited = False  # set by splice.watermark_band after a write-back
    ctx.undo = None     # band-edit snapshot (splice.watermark_band)
    return ctx


def emit_jpeg_transcode(ctx: JpegSpliceContext,
                        reenc: np.ndarray) -> bytes:
    """Splice-emit a baseline JFIF stream from ctx after the caller
    edited ctx.planes in place: MCUs flagged in `reenc` (uint8,
    (mcus_y, mcus_x) or flat) are re-symbolized with the input's own
    Huffman tables; every other MCU's bits are copied from the original
    entropy stream. Raises NativeCodecError when the input's (possibly
    optimized) tables cannot express an edited block — callers fall
    back to a full re-encode."""
    lib = _load()
    if lib is None or not hasattr(lib, "ip_jpeg_emit_transcode_rst"):
        raise NativeCodecError("splice emitter unavailable")
    n = len(ctx.planes)
    flags = np.ascontiguousarray(reenc, dtype=np.uint8).reshape(-1)
    if flags.size != ctx.nmcus:
        raise NativeCodecError(
            f"reenc has {flags.size} flags, stream has {ctx.nmcus} MCUs")
    pv = list(ctx.planes) + [np.zeros((8, 8), dtype=np.int16)] * (3 - n)
    samp_h = np.array([s[0] for s in ctx.sampling] + [1] * (3 - n),
                      dtype=np.uint8)
    samp_v = np.array([s[1] for s in ctx.sampling] + [1] * (3 - n),
                      dtype=np.uint8)
    w, hgt = ctx.size
    # Worst case: every MCU re-symbolized (~2 bytes/coefficient) plus
    # the copied stream itself plus headers.
    cap = (sum(int(p.size) for p in ctx.planes) * 2
           + ctx.destuff.size + (1 << 16))
    out = np.empty(cap, dtype=np.uint8)
    ri = int(getattr(ctx, "restart_interval", 0) or 0)
    seg = getattr(ctx, "seg_bits", None)
    rc = lib.ip_jpeg_emit_transcode_rst(
        pv[0].ctypes.data_as(ctypes.c_void_p),
        pv[1].ctypes.data_as(ctypes.c_void_p),
        pv[2].ctypes.data_as(ctypes.c_void_p),
        pv[0].strides[0] // 2, pv[1].strides[0] // 2,
        pv[2].strides[0] // 2,
        ctx.qt_slots.ctypes.data_as(ctypes.c_void_p),
        ctx.comp_tq.ctypes.data_as(ctypes.c_void_p),
        ctx.comp_id.ctypes.data_as(ctypes.c_void_p),
        ctx.comp_dc.ctypes.data_as(ctypes.c_void_p),
        ctx.comp_ac.ctypes.data_as(ctypes.c_void_p),
        ctx.dht_bits.ctypes.data_as(ctypes.c_void_p),
        ctx.dht_vals.ctypes.data_as(ctypes.c_void_p),
        ctx.dht_present.ctypes.data_as(ctypes.c_void_p),
        w, hgt, n,
        samp_h.ctypes.data_as(ctypes.c_void_p),
        samp_v.ctypes.data_as(ctypes.c_void_p),
        ctx.destuff.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(ctx.destuff_bits),
        ctx.mcu_bits.ctypes.data_as(ctypes.c_void_p),
        flags.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), cap,
        ri,
        seg.ctypes.data_as(ctypes.c_void_p) if seg is not None else None)
    if rc < 0:
        raise NativeCodecError(f"splice emit failed (rc={rc})")
    return out[:rc].tobytes()


def encode_jpeg(rgb: np.ndarray, quality: int = 85) -> bytes:
    lib = _libjpeg()
    rgb = np.asarray(rgb)
    # The native encoder unconditionally reads 3 bytes/pixel: anything
    # narrower would make it read past the final row (heap OOB).
    if rgb.ndim != 3 or rgb.shape[2] < 3:
        raise NativeCodecError(
            f"encode_jpeg needs an (H, W, >=3) array, got {rgb.shape}")
    rgb = np.ascontiguousarray(rgb[:, :, :3], dtype=np.uint8)
    out_p = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.ip_jpeg_encode(rgb.ctypes.data_as(ctypes.c_void_p),
                            rgb.shape[1], rgb.shape[0], rgb.strides[0],
                            int(quality), ctypes.byref(out_p),
                            ctypes.byref(out_len))
    if rc != 0:
        raise NativeCodecError(f"encode failed (rc={rc})")
    try:
        return ctypes.string_at(out_p, out_len.value)
    finally:
        lib.ip_free(out_p)


def is_progressive(data: bytes) -> bool:
    """Header-only probe: True for SOF2 (progressive) streams. Raises
    NativeCodecError on unparseable headers."""
    lib = _load()
    if lib is None or not hasattr(lib, "ip_jpeg_scan_tables"):
        raise NativeCodecError("scanner unavailable")
    comp_id = np.zeros(3, dtype=np.uint8)
    comp_tq = np.zeros(3, dtype=np.uint8)
    comp_dc = np.zeros(3, dtype=np.uint8)
    comp_ac = np.zeros(3, dtype=np.uint8)
    dht_bits = np.zeros((8, 17), dtype=np.uint8)
    dht_vals = np.zeros((8, 256), dtype=np.uint8)
    dht_present = np.zeros(8, dtype=np.uint8)
    qt = np.zeros((4, 64), dtype=np.uint16)
    nc2 = ctypes.c_int()
    dri = ctypes.c_int()
    prog = ctypes.c_int()
    rc = lib.ip_jpeg_scan_tables(
        data, len(data), ctypes.byref(nc2),
        comp_id.ctypes.data_as(ctypes.c_void_p),
        comp_tq.ctypes.data_as(ctypes.c_void_p),
        comp_dc.ctypes.data_as(ctypes.c_void_p),
        comp_ac.ctypes.data_as(ctypes.c_void_p),
        dht_bits.ctypes.data_as(ctypes.c_void_p),
        dht_vals.ctypes.data_as(ctypes.c_void_p),
        dht_present.ctypes.data_as(ctypes.c_void_p),
        qt.ctypes.data_as(ctypes.c_void_p),
        ctypes.byref(dri), ctypes.byref(prog))
    if rc != 0:
        raise NativeCodecError(f"scan tables failed (rc={rc})")
    return bool(prog.value)


_ROT_MODES = {"transpose": 0, "rot90": 1, "rot270": 2}


def coef_rot_i16(plane: np.ndarray, mode: str) -> np.ndarray:
    """Blocked coefficient-plane rotation (native/ipcodec.cpp
    ip_coef_rot_i16): transpose the 8x8-block grid AND each block, with
    the frequency sign flips the rot90/rot270 decompositions inherit
    from their mirror half. ~6x over numpy's element-wise transpose on
    a 12 MP plane (sequential block-row writes vs cache-hostile
    strides). Raises NativeCodecError when the library lacks the
    symbol; callers fall back to the numpy path."""
    lib = _load()
    if lib is None or not hasattr(lib, "ip_coef_rot_i16"):
        raise NativeCodecError("coef rot unavailable")
    p = np.ascontiguousarray(plane, dtype=np.int16)
    hp, wp = p.shape
    if hp % 8 or wp % 8:
        raise NativeCodecError("plane dims must be block-aligned")
    out = np.empty((wp, hp), dtype=np.int16)
    rc = lib.ip_coef_rot_i16(
        p.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(hp // 8), ctypes.c_int64(wp // 8),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(_ROT_MODES[mode]))
    if rc != 0:
        raise NativeCodecError(f"coef rot failed (rc={rc})")
    return out


def gif_quantize_plan9(rgb: np.ndarray, dither: bool = True
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Quantize (H, W, 3) uint8 RGB to Go's gif.Encode semantics: the
    fixed Plan9 palette with Floyd-Steinberg dithering (native/
    gifquant.cpp — bit-exact drawPaletted arithmetic; reference:
    internal/usecase/processor/operations/resize.go:98-119 via Go
    image/gif/writer.go). Returns (indices (H, W) uint8, palette
    (256, 3) uint8)."""
    lib = _load()
    if lib is None or not hasattr(lib, "ip_gif_quantize_plan9"):
        raise NativeCodecError("gif quantizer unavailable")
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] < 3:
        raise NativeCodecError(
            f"gif_quantize needs an (H, W, >=3) array, got {rgb.shape}")
    rgb = np.ascontiguousarray(rgb[:, :, :3], dtype=np.uint8)
    h, w = rgb.shape[:2]
    idx = np.empty((h, w), dtype=np.uint8)
    pal = np.empty((256, 3), dtype=np.uint8)
    rc = lib.ip_gif_quantize_plan9(
        rgb.ctypes.data_as(ctypes.c_void_p), w, h, rgb.strides[0],
        1 if dither else 0,
        idx.ctypes.data_as(ctypes.c_void_p),
        pal.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise NativeCodecError(f"gif quantize failed (rc={rc})")
    return idx, pal


def crc32c(data: bytes, crc: int = 0) -> int | None:
    """Native CRC-32C (Castagnoli); None when the library is unavailable
    so callers (broker/kafkawire.py) fall back to the Python table."""
    lib = _load()
    if lib is None or not hasattr(lib, "ip_crc32c"):
        return None
    return int(lib.ip_crc32c(data, len(data), crc & 0xFFFFFFFF))
