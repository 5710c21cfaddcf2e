"""Slot updates without scatter ops.

Every in-loop record in the engines writes one dynamic SLOT per lane into a
small fixed width (W window records, S seed slots).  A one-hot select over
the width is O(B*W) elementwise work that fuses into the surrounding loop
body, where `arr.at[rows, slot].set(val)` would be a scatter.  Whether the
scatter is slower on the GPU is not measured yet.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tslot_set(arr, slot, mask, val):
    """arr[slot[b], b] = val[b] where mask[b] — the TRANSPOSED layout.

    arr [W, B]: the batch rides the 128-lane minor dim, so nothing is padded
    (a [B, W] layout pads W up to 128 lanes — 5-16x physical blowup that
    dominates loop-carried record arrays)."""
    onehot = jax.lax.broadcasted_iota(jnp.int32, arr.shape, 0) == (
        slot[None, :].astype(jnp.int32))
    v = jnp.asarray(val, dtype=arr.dtype)
    v = v[None, :] if v.ndim else v
    return jnp.where(onehot & mask[None, :], v, arr)


def tslot_get(arr, slot):
    """arr[slot[b], b] via one-hot dot; arr [W, B]."""
    onehot = jax.lax.broadcasted_iota(jnp.int32, arr.shape, 0) == (
        slot[None, :].astype(jnp.int32))
    return jnp.sum(jnp.where(onehot, arr, 0), axis=0)


def window_entry_ids(ws, wc, nrec, max_k: int):
    """Vectorized replacement for the W-pass right-append expansion.

    Windows w < nrec[b] carry (entry offset ws[b,w], count wc[b,w]); the
    output buffer packs them to the RIGHT, newest window leftmost, clipping
    per-window at remaining capacity exactly like engine.markers._append_right
    (overflow keeps each window's TAIL entries).  Returns (entry [B, K] global
    entry ids, valid [B, K], used [B], total [B]) so the caller does ONE value
    gather instead of W.
    """
    B, W = ws.shape
    K = max_k
    dt = ws.dtype
    live = jax.lax.broadcasted_iota(jnp.int32, (B, W), 1) < (
        nrec[:, None].astype(jnp.int32))
    raw = jnp.where(live, wc, 0)
    cntc = jnp.minimum(raw, K)
    P = jnp.minimum(jnp.cumsum(cntc, axis=1), K)  # P[:, w] = used after w+1 windows
    P0 = jnp.concatenate([jnp.zeros((B, 1), dt), P[:, :-1]], axis=1)  # used before w
    used = P[:, -1] if W else jnp.zeros(B, dt)
    total = jnp.sum(raw, axis=1)

    q = jnp.arange(K, dtype=dt)[None, :]  # output column
    r = K - q  # windows satisfy P0[w] < r <= P[w]
    # owner window per column + its (ws, P0, cntc) via one-hot contraction
    inwin = (P0[:, :, None] < r[:, None, :]) & (r[:, None, :] <= P[:, :, None])
    inwin = inwin & live[:, :, None] & (cntc[:, :, None] > 0)

    def pick(v):
        return jnp.sum(jnp.where(inwin, v[:, :, None], 0), axis=1)

    w_ws = pick(ws)
    w_p0 = pick(P0)
    w_cnt = pick(cntc)
    src = q - K + w_p0 + w_cnt
    valid = jnp.any(inwin, axis=1) & (r <= used[:, None])
    entry = jnp.where(valid, w_ws + src, 0)
    return entry, valid, used, total
