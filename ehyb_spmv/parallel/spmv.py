"""Multi-chip EHYB SpMV over a JAX device mesh.

The reference is strictly single-GPU (SURVEY.md §2 "Parallelism strategies": no
MPI/NCCL; the MPI include is commented out at ``kernel.h:12``) — but its
partition/reorder machinery is exactly the preprocessing a distributed
row-partitioned SpMV needs: METIS minimizes the edge cut, which at the chip
level is the halo the devices must exchange.  This module is the
realization sketched in SURVEY.md §5 "Distributed communication backend":

  * rows (in the reordered space) are sharded in equal ``R``-row spans over a
    1-D mesh axis ``"parts"`` — partition-aligned because the reorderer already
    grouped tightly-coupled rows contiguously;
  * the SELL **body** reads x windows that live on-device or in a ±window halo
    fetched from the ring neighbors with ``jax.lax.ppermute`` — the distributed
    analog of the kernel's cached phase (``kernel.cu:150-168``).  On the GPU
    the body and ER tail run the same Triton slice kernel as the one-device
    flagship (``ops/sell_triton.py``);
  * the **ER tail + long rows** read arbitrary global columns, served by a
    COMPRESSED ``all_to_all`` exchange over per-(owner, requester) request
    lists computed at convert time — received bytes ∝ the cut, not the
    dimension (the analog of the kernel's uncached global phase,
    ``kernel.cu:169-194``, made cut-proportional).

Everything is SPMD via ``jax.shard_map`` with static per-shard shapes: the
per-device EHYB sub-formats are padded to common shapes and stacked on a
leading device axis.  Works on a
single-process mesh and across processes under ``jax.distributed``
(``scripts/multihost.py``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EhybConfig, LANES, cdiv, round_up
from ..core.convert import convert_core
from ..core.coo import MatrixCOO
from ..core.ehyb import EhybDevice
from ..core.planner import Plan, make_plan
from ..core.reorder import Reordering, identity_reordering, two_level_reorder
from ..models.base import SpmvModel
from ..ops.xla_ops import (combine_ehyb, ehyb_body_xla, ehyb_dia_xla,
                           ehyb_er_xla, ehyb_long_xla)
from ..partition import partition_rows
from ..utils.log import get_logger

log = get_logger(__name__)

AXIS = "parts"


def _pad_rows(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    """Pad axis 0 of ``a`` to length n with ``fill``."""
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


@dataclasses.dataclass
class ShardedEhyb:
    """Stacked per-device EHYB arrays (leading axis = device)."""

    dim: int            # true rows
    rows_per_dev: int   # R (multiple of LANES)
    window_rows: int    # W <= R
    n_dev: int

    ell_col: np.ndarray          # (D, steps, C)
    ell_val: np.ndarray
    slice_offset: np.ndarray     # (D, R/C + 1)
    slice_win_start: np.ndarray  # (D, R/C)  — offsets into the EXTENDED x
    step_win: np.ndarray         # (D, steps) — per-step window starts (ext x)
    step_win_b: np.ndarray       # (D, steps) — rx second windows (or 0s)
    er_col: np.ndarray           # (D, er_steps, C) — GLOBAL columns
    er_val: np.ndarray
    er_slice_offset: np.ndarray  # (D, n_er_slices + 1)
    er_rows: np.ndarray          # (D, n_er_slices*C) — LOCAL rows, dump = R
    long_col: np.ndarray         # (D, L) — GLOBAL columns
    long_val: np.ndarray
    long_seg: np.ndarray         # (D, L)
    long_rows: np.ndarray        # (D, n_long) — LOCAL rows, dump = R

    #: Union of all shards' diagonal offsets (static; SPMD programs must be
    #: uniform, so shards missing an offset carry an all-zero dia_val row).
    dia_offsets: tuple = ()
    dia_val: np.ndarray = None   # (D, K_union, R)

    # --- compressed halo exchange (replaces the all_gather of x) ---
    #: (D, D, S) int32 — send_idx[o, d] = LOCAL x indices owner o sends to
    #: requester d (padded with 0; padding values are ignored by the
    #: remapped ER/long columns).  S = max request size over all (d, o)
    #: pairs; S == 0 means every ER/long column is within the ±W halo and
    #: no exchange is needed.  Received bytes per device = D*S*4 ∝ the
    #: worst per-pair cut, NOT the dimension (the all_gather it replaces
    #: moved D*R*4 regardless of structure).
    send_idx: np.ndarray = None
    exchange_slots: int = 0      # S

    stats: dict = dataclasses.field(default_factory=dict)


def _refine_within_shards(m: MatrixCOO, reordering: Reordering, R: int,
                          n_dev: int, config: EhybConfig) -> Reordering:
    """Compose a per-shard-local RCM on top of the global partition reorder
    when it reduces the estimated body steps.

    Shard membership (and therefore the cut / exchange plan) is unchanged —
    rows permute within their own ``R``-row span only.  Kept only where the
    sampled step estimate improves by >20%% (banded structure hiding under
    the scramble); identity otherwise (e.g. DIA-dominated FEM shards, where
    RCM would perturb the diagonal structure for nothing).
    """
    from ..core.ordering import estimate_mw_steps, rcm_order

    dim = m.dimension
    new_to_old = reordering.new_to_old
    old_to_new = reordering.old_to_new
    row1 = old_to_new[m.row]
    col1 = old_to_new[m.col]
    local_perm = np.arange(dim, dtype=np.int64)  # final-new → current-new
    changed = False
    _SAMPLE = 5_000_000
    for d in range(n_dev):
        b0, b1 = d * R, min((d + 1) * R, dim)
        if b1 <= b0:
            break
        sel = (row1 >= b0) & (row1 < b1) & (col1 >= b0) & (col1 < b1)
        if not sel.any():
            continue
        r_l = row1[sel] - b0
        c_l = col1[sel] - b0
        n_l = b1 - b0
        if r_l.size > _SAMPLE:
            # pre-gate on a sample: skip the (expensive) local RCM when the
            # partition ordering is already tight — e.g. DIA-dominated FEM
            # shards, where minutes of BFS would buy nothing
            rng = np.random.default_rng(d)
            pick = rng.random(r_l.size) < _SAMPLE / r_l.size
            est_s = estimate_mw_steps(r_l[pick], c_l[pick],
                                      n_l, config.slice_rows,
                                      max(1, config.min_window_group_nnz))
            ideal_s = max(1, int(pick.sum()) // config.slice_rows)
            if est_s < 3 * ideal_s:
                continue  # padding already low; RCM can't win 20%
        est_id = estimate_mw_steps(r_l, c_l, n_l, config.slice_rows,
                                   config.min_window_group_nnz)
        sub = MatrixCOO(n_l, n_l, r_l, c_l, np.ones(r_l.shape[0]))
        order = rcm_order(sub)                    # local new → local current
        inv = np.empty(n_l, dtype=np.int64)
        inv[order] = np.arange(n_l, dtype=np.int64)
        est_rcm = estimate_mw_steps(inv[r_l], inv[c_l], n_l,
                                    config.slice_rows,
                                    config.min_window_group_nnz)
        if est_rcm < 0.8 * est_id:
            local_perm[b0:b1] = b0 + order
            changed = True
            log.info("shard %d: local RCM cuts estimated steps %d → %d",
                     d, est_id, est_rcm)
    if not changed:
        return reordering
    final_new_to_old = new_to_old[local_perm]
    final_old_to_new = np.empty(dim, dtype=np.int64)
    final_old_to_new[final_new_to_old] = np.arange(dim, dtype=np.int64)
    # partition sub-boundaries inside a shard are meaningless after a local
    # re-sort; keep a uniform 1024-row grid (the multi-window layouts pick
    # windows per entry anyway)
    bounds = np.arange(0, dim + 1024, 1024, dtype=np.int64)
    bounds = np.unique(np.minimum(bounds, dim))
    return Reordering(new_to_old=final_new_to_old,
                      old_to_new=final_old_to_new, boundaries=bounds)


def build_sharded(m_r: MatrixCOO, reordering: Reordering, window_rows: int,
                  n_dev: int, config: EhybConfig) -> ShardedEhyb:
    """Slice the reordered matrix into D row spans and convert each span with
    device-local row/window coordinates; pad + stack to uniform shapes."""
    dim = m_r.dimension
    R = round_up(cdiv(dim, n_dev), LANES)
    W = min(window_rows, R)  # halo is one neighbor deep: window ≤ shard span

    # Hub-row splitting is a single-chip mechanism: _shard_body carries no
    # fold-back maps and truncates y to R rows, so a shard's synthetic
    # overflow rows would silently drop their partial sums; splitting also
    # would break the uniform per-shard slice count.  Disable per shard.
    if config.row_split_threshold:
        log.info("sharded path: hub-row splitting disabled per shard")
        config = dataclasses.replace(config, row_split_threshold=0)

    shards = []
    for d in range(n_dev):
        b0, b1 = d * R, min((d + 1) * R, dim)
        sel = (m_r.row >= b0) & (m_r.row < b1)
        row_l = m_r.row[sel] - b0
        col_l = m_r.col[sel] - b0  # off-device cols go negative / beyond R
        val_l = m_r.val[sel]

        # Local partition boundaries: global boundaries restricted to this
        # span, in local coords; the boundary just below b0 is kept (negative)
        # so rows of a straddling partition keep their true window start —
        # clamped to -W so every window fits inside the ±W halo (entries of a
        # deeper straddle simply classify as ER; the planner keeps partitions
        # ≤ the shard span, so this is a corner case, not the common path).
        gb = reordering.boundaries.astype(np.int64)
        below = gb[gb <= b0]
        first = max(below.max() - b0, -W) if below.size else 0
        inside = gb[(gb > b0) & (gb < b1)] - b0
        bounds_l = np.concatenate([[first], inside, [R]])

        # DIA offsets are bounded to ±W, and multi-window body columns to the
        # [-W, R+W) halo span, so every x access stays inside the
        # [halo_W | local_R | halo_W] extended vector (x_base = W); columns
        # further off-device go to the globally-gathered ER tail.
        e = convert_core(row_l, col_l, val_l, dim=R, boundaries=bounds_l,
                         window_rows=W, n_parts=len(bounds_l) - 1,
                         config=config, dia_off_range=(-W, W),
                         body_col_range=(-W, R + W))
        # Window starts into the extended x [halo_W | local_R | halo_W].
        e.slice_win_start = (e.slice_win_start.astype(np.int64) + W).astype(np.int32)
        e.step_win = (e.step_win.astype(np.int64) + W).astype(np.int32)
        if e.step_win_b.size:
            e.step_win_b = (e.step_win_b.astype(np.int64)
                            + W).astype(np.int32)
        if e.step_win_c.size:  # quad windows shift with the ext x too
            e.step_win_c = (e.step_win_c.astype(np.int64)
                            + W).astype(np.int32)
            e.step_win_d = (e.step_win_d.astype(np.int64)
                            + W).astype(np.int32)
        # ER/long columns back to global coordinates (padding cells have
        # val == 0, so the shifted padding gather is harmless).
        e.er_col = (e.er_col.astype(np.int64) + b0).astype(np.int32)
        e.long_col = (e.long_col.astype(np.int64) + b0).astype(np.int32)
        shards.append(e)

    # ---- compressed halo exchange plan (SURVEY §5/§7: the distributed
    # analog of the cached/global phase split, kernel.cu:150-168 vs 169-194;
    # replaces the O(dim) all_gather with per-pair request lists whose size
    # is the actual cut) ----
    XLEN = R + 2 * W
    needs = []
    for d, s in enumerate(shards):
        b0 = d * R
        cols = []
        if s.er_col.size:
            cols.append(s.er_col[np.asarray(s.er_val) != 0].astype(np.int64))
        if s.long_col.size:
            cols.append(s.long_col[np.asarray(s.long_val) != 0]
                        .astype(np.int64))
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        off = cols[(cols < b0 - W) | (cols >= b0 + R + W)]
        needs.append(np.unique(off))
    # Vectorized owner-major plan build (VERDICT r2 next #9: the former
    # O(D^2) Python pair loops with per-pair np.unique/searchsorted were
    # O(D^2) host work; this is linear in total requests + one bincount).
    # ``needs[d]`` is sorted, so each owner's run is contiguous within it.
    all_d = np.concatenate([np.full(n.size, d, dtype=np.int64)
                            for d, n in enumerate(needs)]) \
        if n_dev else np.zeros(0, np.int64)
    all_col = np.concatenate(needs) if needs else np.zeros(0, np.int64)
    all_owner = all_col // R
    req_sizes = np.bincount(all_d * n_dev + all_owner,
                            minlength=n_dev * n_dev) \
        .reshape(n_dev, n_dev).astype(np.int64)
    S = int(req_sizes.max(initial=0))
    send_idx = np.zeros((n_dev, n_dev, max(S, 1)), dtype=np.int32)
    if all_col.size:
        key = all_d * n_dev + all_owner
        run_first = np.empty(key.size, dtype=bool)
        run_first[0] = True
        np.not_equal(key[1:], key[:-1], out=run_first[1:])
        starts = np.flatnonzero(run_first)
        rank = np.arange(key.size, dtype=np.int64) \
            - np.repeat(starts, np.diff(np.append(starts, key.size)))
        send_idx.reshape(-1)[
            (all_owner * n_dev + all_d) * max(S, 1) + rank] = \
            (all_col - all_owner * R).astype(np.int32)
    # owner-run starts within each shard's sorted needs (for remapping)
    owner_starts = [np.searchsorted(needs[d], np.arange(n_dev + 1) * R)
                    for d in range(n_dev)]

    def remap_cols(col_arr: np.ndarray, d: int) -> np.ndarray:
        """Global columns → indices into [x_ext (R+2W) | recv (D*S)]."""
        b0 = d * R
        c = col_arr.astype(np.int64)
        out = c - b0 + W
        off_m = (c < b0 - W) | (c >= b0 + R + W)
        if off_m.any():
            co = c[off_m]
            o = co // R
            pos = np.searchsorted(needs[d], co) - owner_starts[d][o]
            out[off_m] = XLEN + o * S + pos
        return out.astype(np.int32)

    for d, s in enumerate(shards):
        s.er_col = remap_cols(s.er_col, d)
        s.long_col = remap_cols(s.long_col, d)

    # ---- pad to common shapes + stack ----
    C = config.slice_rows
    steps = max(max(s.ell_col.shape[0] for s in shards), 1)
    er_steps = max(max(s.er_col.shape[0] for s in shards), 1)
    n_er_slices = max(max(s.n_er_slices for s in shards), 1)
    n_long = max(max(s.n_long for s in shards), 1)
    n_long_entries = max(max(s.long_col.shape[0] for s in shards), 1)

    def stack(field_fn):
        return np.stack([field_fn(s) for s in shards], axis=0)

    # Union of DIA offsets across shards → uniform static metadata.
    union = sorted({int(d) for s in shards for d in s.dia_offsets})
    K = len(union)
    rank = {d: k for k, d in enumerate(union)}
    dia_val = np.zeros((n_dev, max(K, 0), R),
                       dtype=shards[0].dia_val.dtype if shards else np.float32)
    for i, s in enumerate(shards):
        for k, d in enumerate(s.dia_offsets):
            dia_val[i, rank[int(d)], : s.dia_val.shape[1]] = s.dia_val[k]

    def pad_offsets(off: np.ndarray, n_slices_target: int, total: int):
        off = off.astype(np.int32)
        out = _pad_rows(off, n_slices_target + 1, fill=off[-1])
        out[-1] = total  # extend the final slice over the padded steps
        return out

    sh = ShardedEhyb(
        dim=dim, rows_per_dev=R, window_rows=W, n_dev=n_dev,
        ell_col=stack(lambda s: _pad_rows(s.ell_col, steps)),
        ell_val=stack(lambda s: _pad_rows(s.ell_val, steps)),
        slice_offset=stack(lambda s: pad_offsets(s.slice_offset,
                                                 s.n_slices, steps)),
        slice_win_start=stack(lambda s: s.slice_win_start),
        step_win=stack(lambda s: _pad_rows(s.step_win, steps, fill=0)),
        step_win_b=stack(lambda s: _pad_rows(
            s.step_win_b if s.step_win_b.size else
            np.zeros_like(s.step_win), steps, fill=0)),
        er_col=stack(lambda s: _pad_rows(s.er_col, er_steps, fill=W)),
        er_val=stack(lambda s: _pad_rows(s.er_val, er_steps)),
        er_slice_offset=stack(lambda s: pad_offsets(s.er_slice_offset,
                                                    n_er_slices, er_steps)),
        er_rows=stack(lambda s: _pad_rows(
            s.er_rows, n_er_slices * config.er_slice_rows, fill=R)),
        long_col=stack(lambda s: _pad_rows(s.long_col, n_long_entries,
                                           fill=W)),
        long_val=stack(lambda s: _pad_rows(s.long_val, n_long_entries)),
        long_seg=stack(lambda s: _pad_rows(s.long_seg, n_long_entries,
                                           fill=n_long - 1)),
        long_rows=stack(lambda s: _pad_rows(s.long_rows, n_long, fill=R)),
        dia_offsets=tuple(union), dia_val=dia_val,
        send_idx=send_idx, exchange_slots=S,
        stats={"per_dev": [s.stats for s in shards], "R": R, "W": W,
               "exchange_slots": S, "req_sizes": req_sizes.tolist(),
               "layout": config.body_layout},
    )
    return sh


def _shard_body(sh_meta, x_shard, a):
    """Per-device SPMD body (runs under shard_map; axis name AXIS).
    ``a`` is the dict of stacked per-device arrays (leading axis sharded)."""
    R, W, n_dev, dia_offsets, body_nnz, S, kernel, rx_body = sh_meta
    x_local = x_shard.reshape(-1)  # (R,)

    # Ring halos: left halo = last W rows of the left neighbor, right halo =
    # first W rows of the right neighbor.  Edge devices receive zeros
    # (ppermute semantics), matching the zero-padded x convention.
    left_halo = jax.lax.ppermute(x_local[R - W:], AXIS,
                                 [(i, (i + 1) % n_dev) for i in range(n_dev - 1)])
    right_halo = jax.lax.ppermute(x_local[:W], AXIS,
                                  [(i + 1, i) for i in range(n_dev - 1)])
    x_ext = jnp.concatenate([left_halo, x_local, right_halo])  # (R + 2W,)

    # Compressed exchange for the global-column phases (ER + long rows):
    # every device sends the x values each peer requested at convert time
    # (send_idx) through one all_to_all; ER/long columns were remapped into
    # [x_ext | recv] indices, so received bytes are D*S*4 ∝ the cut — the
    # all_gather this replaces moved D*R*4 no matter the structure
    # (kernel.cu:169-194's global phase, made cut-proportional).
    if S > 0 and n_dev > 1:
        payload = jnp.take(x_local, a["send_idx"][0].reshape(-1),
                           axis=0).reshape(n_dev, S)
        recv = jax.lax.all_to_all(payload, AXIS, split_axis=0, concat_axis=0)
        x_cat = jnp.concatenate([x_ext, recv.reshape(-1)])
    else:
        x_cat = x_ext

    dev = EhybDevice(
        dim=R, window_rows=W,
        ell_col=a["ell_col"][0], ell_val=a["ell_val"][0],
        slice_offset=a["slice_offset"][0],
        slice_win_start=a["slice_win_start"][0],
        step_win=a["step_win"][0],
        step_win_b=a["step_win_b"][0] if rx_body
        else a["step_win"][0][:0],
        # quad windows are not used in the sharded path (build_sharded forces
        # windows_per_subtile=2 per shard)
        step_win_c=a["step_win"][0][:0], step_win_d=a["step_win"][0][:0],
        split_src=a["step_win"][0][:0], split_dst=a["step_win"][0][:0],
        er_col=a["er_col"][0], er_val=a["er_val"][0],
        er_slice_offset=a["er_slice_offset"][0], er_rows=a["er_rows"][0],
        long_col=a["long_col"][0], long_val=a["long_val"][0],
        long_seg=a["long_seg"][0], long_rows=a["long_rows"][0],
        dia_val=a["dia_val"][0], dia_offsets=dia_offsets, body_nnz=body_nnz,
        rx_body=rx_body)

    if kernel == "triton":
        from ..ops.sell_triton import ehyb_body_triton, ehyb_er_triton

        body_fn, er_fn = ehyb_body_triton, ehyb_er_triton
    else:
        body_fn, er_fn = ehyb_body_xla, ehyb_er_xla
    y_body = body_fn(dev, x_ext)             # windows into x_ext
    y_er = er_fn(dev, x_cat)                 # remapped ext+recv columns
    y_long = ehyb_long_xla(dev, x_cat)
    y_dia = ehyb_dia_xla(dev, x_ext, x_base=W)  # ±W shifted slices of x_ext
    y = combine_ehyb(dev, y_body, y_er, y_long, y_dia)  # (R + LANES,)
    return y[:R].reshape(1, R)


def make_sharded_apply(sh: ShardedEhyb, mesh: jax.sharding.Mesh,
                       dtype: str = "float32", kernel: str = "xla"):
    """Returns (apply_fn, device_arrays): ``apply_fn(arrays, x_global)`` runs
    the distributed SpMV; ``x_global`` is the reordered x padded to (D, R).

    ``kernel``: "xla" or "triton" for the body and ER tail (see
    :func:`~..models.ehyb.body_kernel`).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    D, R, W = sh.n_dev, sh.rows_per_dev, sh.window_rows
    spec_dev = P(AXIS)  # shard leading device axis
    multiproc = any(d.process_index != jax.process_index()
                    for d in mesh.devices.flat)

    def to_dev(a, cast=False):
        a = np.asarray(a, dtype=dtype) if cast else np.asarray(a)
        sharding = NamedSharding(mesh, spec_dev)
        if multiproc:
            # Every process holds the full host arrays (conversion is
            # replicated); hand each device its shard (jax.distributed path,
            # SURVEY §4's multi-process CPU simulation prescription).
            return jax.make_array_from_callback(
                a.shape, sharding, lambda idx: a[idx])
        return jax.device_put(jnp.asarray(a), sharding)

    arrays = dict(
        send_idx=to_dev(sh.send_idx),
        ell_col=to_dev(sh.ell_col), ell_val=to_dev(sh.ell_val, cast=True),
        slice_offset=to_dev(sh.slice_offset),
        slice_win_start=to_dev(sh.slice_win_start),
        step_win=to_dev(sh.step_win),
        step_win_b=to_dev(sh.step_win_b),
        er_col=to_dev(sh.er_col), er_val=to_dev(sh.er_val, cast=True),
        er_slice_offset=to_dev(sh.er_slice_offset), er_rows=to_dev(sh.er_rows),
        long_col=to_dev(sh.long_col), long_val=to_dev(sh.long_val, cast=True),
        long_seg=to_dev(sh.long_seg), long_rows=to_dev(sh.long_rows),
        dia_val=to_dev(sh.dia_val, cast=True),
    )
    body_nnz = sum(s.get("nnz_ell", 1) for s in sh.stats.get("per_dev", [{}]))
    rx_body = sh.stats.get("layout") == "sell_rx"
    body = partial(_shard_body, (R, W, D, sh.dia_offsets, body_nnz,
                                 sh.exchange_slots, kernel, rx_body))

    def apply_impl(arrs, x_global):
        x2 = x_global.reshape(D, R)
        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(AXIS, None), {n: P(AXIS) for n in arrs}),
            out_specs=P(AXIS, None),
            # a pallas_call carries no varying-mesh-axes types through its
            # kernel body, so the check runs only on the XLA formulation
            check_vma=kernel != "triton")
        y2 = f(x2, arrs)
        return y2.reshape(D * R)

    return jax.jit(apply_impl), arrays


class ShardedEhybSpmv(SpmvModel):
    """Multi-chip EHYB model: global partition+reorder, uniform row sharding,
    halo'd window body + all-gathered ER tail."""

    name = "ehyb_sharded"

    def __init__(self, config: Optional[EhybConfig] = None,
                 mesh: Optional[jax.sharding.Mesh] = None):
        super().__init__(config)
        if mesh is None:
            devs = np.array(jax.devices())
            mesh = jax.sharding.Mesh(devs, (AXIS,))
        self.mesh = mesh
        self.n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))

    def setup(self, m: MatrixCOO) -> "ShardedEhybSpmv":
        self.m = m
        cfg = self.config
        dim = m.dimension

        from ..models.ehyb import body_kernel, gpu_layout

        # the same kernel and layout as the one-device flagship
        self._kernel = body_kernel(cfg, jax.default_backend())
        if self._kernel == "triton":
            self.config = cfg = gpu_layout(cfg)

        # Plan windows against the *shard span*: a window must fit inside one
        # device's rows (± one-neighbor halo), so cap W at R and size the
        # partition count to the capped window.
        R = round_up(cdiv(dim, self.n_dev), LANES)
        base_plan = make_plan(dim, cfg)
        W = min(base_plan.window_rows, R)

        n_parts = max(self.n_dev, cdiv(dim, W))
        self.plan = Plan(dim=dim, n_parts=n_parts, window_rows=W,
                         part_align=LANES, padded_dim=round_up(dim, LANES) + W)
        if cfg.features.reorder and self.plan.n_parts > 1:
            labels = partition_rows(m, self.plan.n_parts, cfg.partitioner,
                                    cfg.partition_imbalance)
            self.reordering = two_level_reorder(m, labels, self.plan,
                                                sort_rows=cfg.features.sort_rows)
        else:
            bounds = np.minimum(
                np.arange(self.plan.n_parts + 1) * self.plan.window_rows, dim)
            bounds[-1] = dim
            self.reordering = identity_reordering(dim, bounds)

        # Within-shard local ordering refinement: the global partition
        # grouping minimizes the inter-shard cut, but inside a shard the
        # body's padding depends on LOCAL structure (bandwidth), which RCM
        # recovers far better on scrambled matrices.  Hierarchical: shard
        # assignment stays fixed; rows permute within their span only, so
        # the cut (and the exchange plan) is unaffected.
        if cfg.features.reorder and cfg.body_layout in ("sell_mw", "sell_rx",
                                                        "sell"):
            self.reordering = _refine_within_shards(
                m, self.reordering, round_up(cdiv(dim, self.n_dev), LANES),
                self.n_dev, cfg)

        m_r = self.reordering.apply_to_matrix(m)
        self.sharded = build_sharded(m_r, self.reordering,
                                     self.plan.window_rows, self.n_dev, cfg)
        self._apply_fn, self._arrays = make_sharded_apply(
            self.sharded, self.mesh, cfg.dtype, kernel=self._kernel)
        log.info("sharded EHYB over %d devices: R=%d W=%d body=%s S=%d",
                 self.n_dev, self.sharded.rows_per_dev,
                 self.sharded.window_rows, self._kernel,
                 self.sharded.exchange_slots)
        return self

    def _multiproc(self) -> bool:
        return any(d.process_index != jax.process_index()
                   for d in self.mesh.devices.flat)

    def prepare_x(self, x: np.ndarray) -> jax.Array:
        xr = self.reordering.vector_reorder(np.asarray(x))
        D, R = self.sharded.n_dev, self.sharded.rows_per_dev
        xp = np.zeros(D * R, dtype=self.config.dtype)
        xp[: self.m.n_rows] = xr
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(self.mesh, P(AXIS))
        if self._multiproc():
            return jax.make_array_from_callback(xp.shape, sharding,
                                                lambda idx: xp[idx])
        return jax.device_put(jnp.asarray(xp), sharding)

    def recover_y(self, y: jax.Array) -> np.ndarray:
        if self._multiproc():
            from jax.experimental import multihost_utils

            y = multihost_utils.process_allgather(y, tiled=True)
        y_np = np.asarray(y, dtype=np.float64)[: self.m.n_rows]
        return self.reordering.vector_recover(y_np)

    def apply(self, x_dev: jax.Array) -> jax.Array:
        return self._apply_fn(self._arrays, x_dev)

    @property
    def apply_jit(self):  # _apply_fn is already jitted
        return self.apply
