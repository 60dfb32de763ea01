"""The device decision, made once per process from `jax.default_backend()`.

Every choice that depends on the device lives here, so no other module
tests the backend's name:

* the mesh size behind DEVICE_DATA_AXIS=0 (every local card on a GPU,
  one device on the CPU);
* the device-JPEG auto policy (a GPU, the native entropy scanner, and a
  host with too few cores to feed the card through the host codec);
* the DEVICE_PLATFORM check: a worker configured for an accelerator
  that comes up on the CPU exits instead of serving there;
* where the persistent compile cache lives.
"""

from __future__ import annotations

import os
import pathlib
from dataclasses import dataclass
from typing import Mapping

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]

# DEVICE_PLATFORM values that name an accelerator.
ACCELERATOR_PLATFORMS = ("gpu", "cuda")

# Device-JPEG crossover, in host cores per card: below it the composed
# device decode -> pipeline -> encode step serves more 12 MP images per
# second than the host codec pool on the same host, above it the host
# pool does. It is the ratio of two rates measured on an H100 host
# (PERF.md "Device-JPEG crossover"): the composed device step, ~900
# images/s per card, over the host codec's ~7 images/s per core.
DEVICE_JPEG_CORES_PER_CARD = 130


class PlatformError(RuntimeError):
    """JAX came up on another platform than DEVICE_PLATFORM names."""


@dataclass(frozen=True)
class DeviceCaps:
    backend: str   # jax.default_backend(): "gpu" or "cpu"
    kind: str      # device_kind of the first device
    count: int     # local devices

    @property
    def accelerated(self) -> bool:
        return self.backend == "gpu"

    def data_axis(self, requested: int, space: int = 1) -> int:
        """Resolve DEVICE_DATA_AXIS: an explicit size wins; 0 means every
        local card on a GPU and one device on the CPU (the virtual CPU
        devices of a test process are opted into explicitly)."""
        if requested > 0:
            return requested
        return max(1, self.count // space) if self.accelerated else 1

    def device_jpeg_auto(self, native_scan: bool, host_cores: int,
                         cards: int) -> bool:
        """Device-JPEG auto policy: on when the card can take codec work
        and the host cannot feed it through the host codec pool."""
        return (self.accelerated and native_scan
                and host_cores < DEVICE_JPEG_CORES_PER_CARD * max(cards, 1))

    def describe(self) -> dict:
        return {"platform": self.backend, "kind": self.kind,
                "count": self.count}


def detect() -> DeviceCaps:
    import jax

    devs = jax.devices()
    return DeviceCaps(jax.default_backend(), devs[0].device_kind, len(devs))


def card_report() -> str:
    """The card's name and power limit as nvidia-smi reports them (a
    child process that stays off JAX), or "not available"."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip() or "not available"


def require_platform(requested: str, caps: DeviceCaps) -> None:
    """Raise PlatformError when DEVICE_PLATFORM names an accelerator but
    JAX came up on another backend: never serve on the CPU in silence."""
    want = (requested or "").strip().lower()
    if want in ACCELERATOR_PLATFORMS and caps.backend != "gpu":
        raise PlatformError(
            f"DEVICE_PLATFORM={requested!r} but JAX runs on "
            f"{caps.backend!r} ({caps.kind}, {caps.count} device(s))")
    if want == "cpu" and caps.backend != "cpu":
        raise PlatformError(
            f"DEVICE_PLATFORM='cpu' but JAX runs on {caps.backend!r}")


def compile_cache_dir(env: Mapping[str, str] | None = None) -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.jaxcache."""
    env = os.environ if env is None else env
    return env.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_ROOT / ".jaxcache")


def enable_compile_cache(env: Mapping[str, str] | None = None) -> str:
    """Persist XLA compilations across processes (the 12 MP programs are
    the expensive cold compiles). JAX reads JAX_COMPILATION_CACHE_DIR on
    its own; only when it is unset does this point JAX at the fixed
    <checkout>/.jaxcache. Returns the directory in use."""
    import jax

    env = os.environ if env is None else env
    path = compile_cache_dir(env)
    if not env.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


__all__ = ["DeviceCaps", "PlatformError", "compile_cache_dir", "detect",
           "enable_compile_cache", "require_platform",
           "DEVICE_JPEG_CORES_PER_CARD"]
