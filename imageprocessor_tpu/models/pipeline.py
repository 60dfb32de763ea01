"""The flagship compiled model: a fused multi-output processing pipeline.

For one (plan, bucket, batch-size) the model traces a single XLA program
that reads the uint8 source batch once from HBM and produces every
requested artifact — e.g. the service default (thumbnail 200 crop +
resize 1024x768 keep-aspect; reference handler/image/image.go:252-275)
compiles to ONE program with two outputs. XLA CSEs the shared uint8->f32
cast and fuses the elementwise tails; the expensive resample passes are
per-op but all stay device-resident. This replaces the reference's
sequential per-op loop with per-op re-encode round trips
(image_processor.go:64-95).

Shape policy (XLA requires static shapes):
* source canvas  = resolution bucket (B, Hb, Wb, 3) uint8,
* resize canvas  = the requested (height, width) — keep-aspect outputs
  always fit inside it (min-ratio rule),
* thumbnail crop = (size, size); thumbnail aspect = per-group canvas
  quantized up to /64 to bound recompiles,
* watermark/grayscale/flip = full bucket canvas,
* per-image true extents travel as (B, 2) int32 tensors.

Batches are interleaved (B, H, W, 3) whether the host decoded them or
the device JPEG decode produced them on the card (PERF.md: the same
program runs 2.1x slower on planar (B, 3, H, W) batches on an H100).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from imageprocessor_tpu.domain import OperationType
from imageprocessor_tpu.models.plan import NormalizedOp, OperationPlan
from imageprocessor_tpu.ops.extra import (
    batched_crop,
    batched_flip,
    batched_grayscale,
    batched_rotate,
)
from imageprocessor_tpu.ops.resize import batched_resize_bilinear
from imageprocessor_tpu.ops.thumbnail import batched_thumbnail
from imageprocessor_tpu.ops.watermark import (
    _pad_tile,
    batched_watermark_core,
    quantize_tile,
    rasterize_text,
    resolve_color,
)

@dataclass(frozen=True)
class OpOutputSpec:
    """Static output-canvas description for one op in a compiled program."""

    op: NormalizedOp
    canvas: tuple[int, int]  # (out_h, out_w); (0,0) = full bucket canvas


def _quant_up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan_output_specs(plan: OperationPlan, bucket: tuple[int, int],
                      aspect_long_sides: dict[int, int] | None = None,
                      ) -> tuple[OpOutputSpec, ...]:
    """Resolve static canvases. `aspect_long_sides` maps op-index -> the
    max long side needed by the current group for aspect-mode thumbnails
    (content-dependent; quantized /64 by the caller)."""
    specs = []
    for i, op in enumerate(plan.ops):
        if op.type is OperationType.RESIZE:
            specs.append(OpOutputSpec(op, (op.height, op.width)))
        elif op.type is OperationType.THUMBNAIL:
            if op.crop_to_fit:
                specs.append(OpOutputSpec(op, (op.size, op.size)))
            else:
                long_side = (aspect_long_sides or {}).get(i, op.size)
                long_side = max(_quant_up(long_side, 64), op.size)
                specs.append(OpOutputSpec(op, (long_side, long_side)))
        elif op.type is OperationType.CROP:
            specs.append(OpOutputSpec(op, (op.height, op.width)))
        else:  # watermark / grayscale / flip / rotate: full bucket canvas
            specs.append(OpOutputSpec(op, (0, 0)))
    return tuple(specs)


def _wm_static(plan: OperationPlan) -> dict[int, tuple[int, int, str]]:
    """op index -> (tile_h, tile_w, position): the watermark statics a
    compiled program is specialized on."""
    out: dict[int, tuple[int, int, str]] = {}
    for i, op in enumerate(plan.ops):
        if op.type is OperationType.WATERMARK:
            tile = quantize_tile(rasterize_text(op.text, op.font_size))
            th, tw = tile.coverage.shape
            out[i] = (th, tw, op.position)
    return out


class PipelineModel:
    """Builds and caches fused programs keyed by (plan, bucket, B, canvases)."""

    def __init__(self):
        self._cache: dict[tuple, Callable] = {}
        # Device-resident per-geometry args (src_hw, per-op out dims) and
        # watermark tiles: batches with recurring dims (the common case)
        # reuse them instead of paying small H2D transfers every step.
        self._args_cache: dict[tuple, Any] = {}
        self._args_order: list[tuple] = []
        self._lock = threading.Lock()

    # -- program construction -------------------------------------------------

    @staticmethod
    def _build(plan: OperationPlan, specs: tuple[OpOutputSpec, ...],
               wm_static: dict[int, tuple[int, int, str]]):
        """wm_static: op index -> (tile_h, tile_w, position) statics."""

        def step(imgs_u8, src_hw, out_hws, wm_args):
            outputs = []
            for i, spec in enumerate(specs):
                op = spec.op
                if op.type is OperationType.RESIZE or (
                        op.type is OperationType.THUMBNAIL
                        and not op.crop_to_fit):
                    outputs.append(batched_resize_bilinear(
                        imgs_u8, src_hw, out_hws[i],
                        out_h=spec.canvas[0], out_w=spec.canvas[1]))
                elif op.type is OperationType.THUMBNAIL:
                    outputs.append(batched_thumbnail(imgs_u8, src_hw,
                                                     op.size))
                elif op.type is OperationType.WATERMARK:
                    th, tw, position = wm_static[i]
                    outputs.append(batched_watermark_core(
                        imgs_u8, src_hw, *wm_args[i], position=position,
                        tile_h=th, tile_w=tw))
                elif op.type is OperationType.GRAYSCALE:
                    outputs.append(batched_grayscale(imgs_u8))
                elif op.type is OperationType.FLIP:
                    outputs.append(batched_flip(imgs_u8, src_hw,
                                                direction=op.direction))
                elif op.type is OperationType.CROP:
                    ch = min(op.height, imgs_u8.shape[1])
                    cw = min(op.width, imgs_u8.shape[2])
                    outputs.append(batched_crop(imgs_u8, src_hw,
                                                x=op.x, y=op.y,
                                                width=cw, height=ch))
                elif op.type is OperationType.ROTATE:
                    outputs.append(batched_rotate(imgs_u8, src_hw, op.angle))
                else:
                    raise NotImplementedError(
                        f"{op.type} has no batched kernel")
            return tuple(outputs)

        return step

    @staticmethod
    def _donate(plan: OperationPlan) -> tuple[int, ...]:
        # Donating the source batch lets XLA alias the watermark output
        # onto the input buffer: the full-resolution "copy" becomes an
        # in-place region blend (the input is never reused after a step).
        # Only a watermark output shares the input's exact shape/dtype AND
        # can be computed in place, so donation is gated on one being
        # present — donating elsewhere just drops the buffer and emits
        # XLA's "donated buffers were not usable" warning on every step.
        return ((0,) if any(op.type is OperationType.WATERMARK
                            for op in plan.ops) else ())

    # -- public API ------------------------------------------------------------

    def get_program(self, plan: OperationPlan, bucket: tuple[int, int],
                    batch: int, specs: tuple[OpOutputSpec, ...]):
        wm_static = _wm_static(plan)
        key = (plan.compile_key(), bucket, batch,
               tuple(s.canvas for s in specs),
               tuple(sorted(wm_static.items())))
        with self._lock:
            prog = self._cache.get(key)
            if prog is None:
                prog = jax.jit(self._build(plan, specs, wm_static),
                               donate_argnums=self._donate(plan))
                self._cache[key] = prog
        return prog

    def get_raw_step(self, plan: OperationPlan, specs):
        """Un-jitted step function — for callers composing it into larger
        programs (e.g. the benchmark's composed device step)."""
        return self._build(plan, specs, _wm_static(plan))

    def prepare_wm_args(self, plan: OperationPlan) -> dict[int, tuple]:
        """Runtime watermark inputs (tile content, color, metrics).
        Device-cached per watermark spec — repeated steps transfer nothing."""
        # The op INDEX is part of the key: the returned dict is keyed by
        # position in the plan, so [watermark] and [thumbnail, watermark]
        # with identical params must not share a cache entry (the cached
        # {0: ...} would crash the second plan's step() with KeyError).
        key = tuple((i, op.text, op.font_size, op.font_color, op.opacity)
                    for i, op in enumerate(plan.ops)
                    if op.type is OperationType.WATERMARK)
        with self._lock:
            cached = self._args_cache.get(("wm", key))
        if cached is not None:
            return cached
        out: dict[int, tuple] = {}
        for i, op in enumerate(plan.ops):
            if op.type is not OperationType.WATERMARK:
                continue
            tile = quantize_tile(rasterize_text(op.text, op.font_size))
            r, g, b, a = resolve_color(op.font_color, op.opacity)
            out[i] = (
                jnp.asarray(_pad_tile(tile)),
                jnp.asarray([r, g, b], dtype=jnp.float32),
                jnp.float32(a / 255.0),
                jnp.int32(tile.width_px),
                jnp.int32(tile.height_px),
                jnp.int32(tile.ascent),
            )
        with self._lock:
            self._args_cache[("wm", key)] = out
            self._args_order.append(("wm", key))
        return out

    # -- bounded device-arg / program caches (shared with the engine) --------

    def arg_cache_get(self, key):
        """Fetch from the bounded device-arg cache (None on miss)."""
        with self._lock:
            return self._args_cache.get(key)

    def arg_cache_put(self, key, value) -> None:
        """Insert into the device-arg cache. Evicts FIFO past 256 entries."""
        with self._lock:
            self._args_cache[key] = value
            self._args_order.append(key)
            while len(self._args_order) > 256:
                self._args_cache.pop(self._args_order.pop(0), None)

    def prog_cache_get(self, key):
        """Fetch a compiled program by key (None on miss)."""
        with self._lock:
            return self._cache.get(key)

    def prog_cache_put(self, key, prog) -> None:
        with self._lock:
            self._cache[key] = prog

    def _geometry_args(self, plan: OperationPlan, bucket, b: int,
                       src_hw: np.ndarray, out_hws: dict[int, np.ndarray],
                       mesh=None):
        """Device-resident (src_hw, per-op out dims), cached per geometry.
        With a mesh they are placed batch-sharded over its data axis."""
        geo_key = (plan.compile_key(), bucket, b, mesh,
                   src_hw.tobytes(),
                   tuple(sorted((k, np.asarray(v, np.int32).tobytes())
                                for k, v in out_hws.items())))
        cached = self.arg_cache_get(geo_key)
        if cached is not None:
            return cached
        dummy = np.zeros((b, 2), dtype=np.int32)
        host = (src_hw, tuple(np.asarray(out_hws.get(i, dummy), np.int32)
                              for i in range(len(plan.ops))))
        placed = (jax.device_put(host, NamedSharding(mesh, P("data")))
                  if mesh is not None else jax.device_put(host))
        self.arg_cache_put(geo_key, placed)
        return placed

    def run(self, plan: OperationPlan, imgs_u8, src_hw: np.ndarray,
            out_hws: dict[int, np.ndarray],
            specs: tuple[OpOutputSpec, ...]) -> list[Any]:
        """Execute the fused program for one padded group.

        imgs_u8: (B, Hb, Wb, 3), host or device; src_hw: (B, 2); out_hws:
        op index -> (B, 2) valid output dims (only needed for resample
        ops). Returns device arrays in op order.
        """
        b = imgs_u8.shape[0]
        bucket = (imgs_u8.shape[1], imgs_u8.shape[2])
        src_hw_j, hws = self._geometry_args(
            plan, bucket, b, np.asarray(src_hw, dtype=np.int32), out_hws)
        prog = self.get_program(plan, bucket, b, specs)
        outs = prog(jnp.asarray(imgs_u8), src_hw_j, hws,
                    self.prepare_wm_args(plan))
        return list(outs)

    def run_sharded(self, mesh, plan: OperationPlan, imgs_u8,
                    src_hw: np.ndarray, out_hws: dict[int, np.ndarray],
                    specs: tuple[OpOutputSpec, ...]) -> list[Any]:
        """Data-parallel execution over a `jax.sharding.Mesh` 'data' axis.

        The batch is placed straight onto its shards (each card receives
        only its slice) and the step runs under shard_map with the batch
        axis split and watermark args replicated. Images are independent,
        so no collective runs between cards.
        """
        n = int(mesh.shape["data"])
        b = imgs_u8.shape[0]
        if b % n != 0:
            raise ValueError(f"batch {b} not divisible by data axis {n}")
        bucket = (imgs_u8.shape[1], imgs_u8.shape[2])
        src_hw_j, hws = self._geometry_args(
            plan, bucket, b, np.asarray(src_hw, dtype=np.int32), out_hws,
            mesh=mesh)
        prog = self._get_sharded_program(mesh, plan, specs)
        imgs = jax.device_put(imgs_u8, NamedSharding(mesh, P("data")))
        outs = prog(imgs, src_hw_j, hws, self.prepare_wm_args(plan))
        return list(outs)

    def _get_sharded_program(self, mesh, plan: OperationPlan,
                             specs: tuple[OpOutputSpec, ...]):
        """Build-or-fetch the jitted shard_map wrapper for one (mesh,
        plan, geometry). Mesh objects hash by device grid + axis names,
        so one engine-held mesh always hits the same entry."""
        wm_static = _wm_static(plan)
        key = ("sh", mesh, plan.compile_key(),
               tuple(s.canvas for s in specs),
               tuple(sorted(wm_static.items())))
        with self._lock:
            prog = self._cache.get(key)
        if prog is not None:
            return prog
        shard = P("data")
        hws_spec = tuple(shard for _ in range(len(plan.ops)))
        raw = self._build(plan, specs, wm_static)

        def call(imgs, src_hw_j, hws, wm_args):
            fn = jax.shard_map(
                raw, mesh=mesh,
                in_specs=(shard, shard, hws_spec,
                          jax.tree.map(lambda _: P(), wm_args)),
                out_specs=shard)
            return fn(imgs, src_hw_j, hws, wm_args)

        prog = jax.jit(call, donate_argnums=self._donate(plan))
        with self._lock:
            self._cache[key] = prog
        return prog

    def cache_size(self) -> int:
        with self._lock:
            return len(self._cache)


__all__ = ["PipelineModel", "OpOutputSpec", "plan_output_specs"]
