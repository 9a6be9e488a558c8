"""Multi-device execution: block data parallelism over a JAX mesh.

This is the device counterpart of the reference's only parallelism — the
per-block thread pipeline with ordered writes (multithread.c:126-194;
SURVEY.md §2 component 7). Blocks are independent by construction, so:

  * the batch axis B of every kernel shards over a 1-D ``blocks`` mesh axis
    (``shard_map``; block i -> device i mod D after padding B up to D);
  * the reference's join-previous ordered-write chain becomes a plain
    device->host gather of per-block (payload, size) pairs, concatenated in
    block order on the host — ordering is deterministic from the sharding,
    no communication is needed between blocks;
  * multi-host extends the same mesh over processes (jax.distributed);
    sidecar streams (.freq/.cod — KB-scale ASCII) are produced on host 0.

No cross-block collectives exist in the compute path: per SURVEY.md §5.7 the
workload is embarrassingly parallel at block granularity, so the
interconnect carries only the (tiny) size gathers done implicitly by
fetching results to host.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .kernels import decode as kdecode
from .kernels import histogram as khist
from .kernels import pack as kpack
from .kernels import rle as krle

AXIS = "blocks"


def block_mesh(devices=None) -> Mesh:
    """1-D mesh over the given (default: all) devices; axis ``blocks``."""
    devs = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devs), (AXIS,))


def _pad_rows(arrs, n_rows: int, multiple: int):
    """Pad axis-0 of every array to the next multiple (rows are blocks)."""
    target = -(-n_rows // multiple) * multiple
    if target == n_rows:
        return arrs, n_rows
    out = []
    for a in arrs:
        pad = [(0, target - n_rows)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, pad))
    return out, n_rows


def _spec(mesh: Mesh, a):
    return NamedSharding(mesh, P(AXIS, *([None] * (np.ndim(a) - 1))))


class ShardedKernels:
    """The five batched kernels, shard_mapped over a blocks mesh.

    Wrappers pad B to a multiple of the mesh size with zero-length rows
    (every kernel masks by true length, so padding rows cost compute but
    produce empty outputs) and slice the padding back off on the host.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        d = mesh.devices.size
        spec = functools.partial(jax.shard_map, mesh=mesh, check_vma=False)
        self._rle_encode = jax.jit(spec(
            krle.rle_encode_batch,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS))))
        self._hist = jax.jit(spec(
            khist.histogram_batch,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=P(AXIS, None)))
        self._pack = jax.jit(spec(
            kpack.pack_batch,
            in_specs=(P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS, None)),
            out_specs=(P(AXIS, None), P(AXIS))))
        tab_spec = {k: P(AXIS) if k == "n_codes" else P(AXIS, None)
                    for k in ("pc", "pivots", "plen", "psym", "n_codes")}
        tab_spec["dlen2d"] = tab_spec["dsym2d"] = P(AXIS, None, None)
        self._decode = {}  # out_p -> compiled fn (static arg via closure)
        self._tab_spec = tab_spec
        self._expand_sizes = jax.jit(spec(
            krle.rle_expand_sizes,
            in_specs=(P(AXIS, None), P(AXIS)),
            out_specs=P(AXIS)))
        self._expand = {}  # out_p -> compiled fn
        self._pack_compact = {}  # bound -> compiled fn
        self._spec = spec
        self.n_devices = d

    # -- device-resident variants (mesh fused path; jax arrays in/out) ------

    def rle_encode_dev(self, x, lens):
        """Sharded RLE encode keeping outputs device-resident (mesh fused
        path). Caller pads rows to a mesh-size multiple."""
        return self._rle_encode(x, lens)

    def histogram_dev(self, x, lens):
        return self._hist(x, lens)

    def pack_compact_dev(self, x, lens, code_lens, code_vals, bound: int):
        """Sharded pack + PER-SHARD compaction: exact payload bytes.

        bound: static per-shard output byte budget (>= any shard's total
        packed bytes, host-bucketed). Returns a (D * bound,) uint8 device
        array — shard d's rows lie back-to-back at [d * bound, ...) — plus
        the (B,) packed byte lengths. Downloading D * bound ~ payload size
        closes the mesh path's padded-row transfer gap vs single-device
        compaction.
        """
        if bound not in self._pack_compact:
            def fn(xx, ll, cl, cv, bound=bound):
                off, val, bit_total, out_len = kpack.pack_stage1(xx, ll, cl,
                                                                 cv)
                flat = kpack.pack_compact(off, val, bit_total, out_len, bound)
                return flat, out_len
            self._pack_compact[bound] = jax.jit(self._spec(
                fn,
                in_specs=(P(AXIS, None), P(AXIS), P(AXIS, None),
                          P(AXIS, None)),
                out_specs=(P(AXIS), P(AXIS))))
        return self._pack_compact[bound](x, lens, code_lens, code_vals)

    # -- per-kernel public wrappers (numpy in / numpy out, any B) ----------

    def rle_encode(self, x, lens):
        (xp, lp), n = _pad_rows([x, lens], x.shape[0], self.n_devices)
        enc, out_len = self._rle_encode(xp, lp)
        return np.asarray(enc)[:n], np.asarray(out_len)[:n]

    def histogram(self, x, lens):
        (xp, lp), n = _pad_rows([x, lens], x.shape[0], self.n_devices)
        return np.asarray(self._hist(xp, lp))[:n]

    def pack(self, x, lens, code_lens, code_vals):
        (xp, lp, cl, cv), n = _pad_rows(
            [x, lens, code_lens, code_vals], x.shape[0], self.n_devices)
        packed, plen = self._pack(xp, lp, cl, cv)
        return np.asarray(packed)[:n], np.asarray(plen)[:n]

    def decode(self, payload, plens, tables, counts, out_p: int):
        if out_p not in self._decode:
            fn = functools.partial(kdecode.decode_batch_fused, out_p=out_p)
            self._decode[out_p] = jax.jit(self._spec(
                lambda pl, ln, tab, ct: fn(pl, ln, tab, ct),
                in_specs=(P(AXIS, None), P(AXIS), self._tab_spec, P(AXIS)),
                out_specs=(P(AXIS, None), P(AXIS))))
        n = payload.shape[0]
        (pp, lp, cp), _ = _pad_rows([payload, plens, counts], n,
                                    self.n_devices)
        tabp = {k: _pad_rows([v], n, self.n_devices)[0][0]
                for k, v in tables.items()}
        # padding rows need a decodable table: copy row 0 into the padding
        if pp.shape[0] != n:
            for k, v in tabp.items():
                v[n:] = tables[k][:1]
        out, under = self._decode[out_p](pp, lp, tabp, cp)
        return np.asarray(out)[:n], np.asarray(under)[:n]

    def expand_sizes(self, x, lens):
        (xp, lp), n = _pad_rows([x, lens], x.shape[0], self.n_devices)
        return np.asarray(self._expand_sizes(xp, lp))[:n]

    def expand(self, x, lens, out_p: int):
        if out_p not in self._expand:
            fn = functools.partial(krle.rle_expand_batch, out_p=out_p)
            self._expand[out_p] = jax.jit(self._spec(
                lambda xx, ll: fn(xx, ll),
                in_specs=(P(AXIS, None), P(AXIS)),
                out_specs=(P(AXIS, None), P(AXIS))))
        (xp, lp), n = _pad_rows([x, lens], x.shape[0], self.n_devices)
        out, out_len = self._expand[out_p](xp, lp)
        return np.asarray(out)[:n], np.asarray(out_len)[:n]
