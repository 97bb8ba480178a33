"""Routing-network tables on the host (counterpart of ``tpcg/ops/routing.py``).

The JAX package computes an unstructured SpMV on the TPU as
``y = sum_l vals_l * benes_l(x)``: the nonzeros are split into layers that
hold at most one entry per row and per column, each layer's permutation
``target row i <- source column c_l(i)`` is routed through an XOR-Benes
network of ``2 log2(m) - 1`` masked butterfly stages, and the TPU applies
the stages as rolls and selects because it has no usable gather.  The
tables (masks and values in target order) are built once on the host and
saved to an ``.npz`` that ``cg(routing=)`` loads (``python -m tpcg.cli
route``).

The H100 gathers well, so the port's device path is a CSR SpMV
(``tpcg_torch.ops.route_spmv``).  This module keeps the host side so that
tables move between the packages in both directions:

* :func:`benes_masks`, :func:`benes_strides`, :func:`apply_benes_numpy`,
  :func:`assign_layers`, :class:`RoutedSpmv` and :func:`build_routing_spmv`
  are copies of JAX's numpy code, bit for bit at the same seed;
* :func:`pack_masks` / :func:`unpack_masks` are JAX's 1-bit mask packing
  (``tpcg/ops/route_spmv.py:49-81``), the ``.npz`` layout;
* :func:`routed_to_csr` rebuilds the CSR matrix from the tables, which is
  what ``routing=`` hands to the device.

numpy and scipy only: no torch, no JAX.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

STAGES_PER_WORD = 32     # 1 exchange bit per stage in an int32 word


# ---------------------------------------------------------------------------
# Benes routing
# ---------------------------------------------------------------------------

def _orbit_min(T: np.ndarray) -> np.ndarray:
    """leader[i] = min element index on i's orbit under permutation T."""
    leader = np.arange(len(T))
    nxt = T
    steps = max(1, int(np.ceil(np.log2(len(T)))) + 1)
    for _ in range(steps):
        leader = np.minimum(leader, leader[nxt])
        nxt = nxt[nxt]
    return leader


def benes_masks(perm: np.ndarray) -> np.ndarray:
    """Switch masks routing ``out[j] = in[perm[j]]`` on an XOR-Benes net.

    perm : (m,) permutation, m a power of two >= 2.
    Returns masks (2*b - 1, m) int8 in {-1, 0, +1}; stage k with stride
    ``s = benes_strides(m)[k]`` takes ``t[j + s]`` where the mask is +1,
    ``t[j - s]`` where it is -1, and keeps ``t[j]`` where it is 0 (indices
    cyclic), as :func:`apply_benes_numpy` does.
    """
    perm = np.asarray(perm, dtype=np.int64)
    m = len(perm)
    b = int(np.log2(m))
    assert 1 << b == m, "m must be a power of two"
    n_stages = 2 * b - 1
    masks = np.zeros((n_stages, m), dtype=np.int8)

    # sig: where the element at each position must exit its current block
    sig = np.argsort(perm)
    pos_id = np.arange(m)

    for d in range(b - 1):
        mblk = m >> d            # current block size
        h = mblk >> 1
        blk = pos_id & ~(mblk - 1)          # block base of each position
        loc = pos_id - blk                   # local position in block

        # two-hop permutation on positions within blocks; the 2-colouring
        # is constant on its orbits and complementary across i ^ h
        xor_h = blk + (loc ^ h)
        inv = np.empty(m, dtype=np.int64)
        inv[blk + sig] = pos_id
        T = inv[blk + (sig[xor_h] ^ h)]
        leader = _orbit_min(T)
        upper = leader < leader[xor_h]

        # input stage: a low element that is not "upper" swaps with i + h
        low = loc < h
        swap_low = low & ~upper
        masks[d][swap_low] = 1
        masks[d][pos_id[swap_low] + h] = -1

        sw = np.where(swap_low)[0]
        sig2 = sig.copy()
        sig2[sw], sig2[sw + h] = sig[sw + h], sig[sw]

        # output stage: the upper-network element at local exit slot o
        # swaps when its target is o + h
        out_stage = n_stages - 1 - d
        up_pos = blk + (sig2 & (h - 1))
        tgt_low = sig2 & h
        swap_out = np.zeros(m, dtype=bool)
        in_upper = loc < h
        sel = in_upper & (tgt_low != 0)
        swap_out[up_pos[sel]] = True
        o_idx = np.where(swap_out)[0]
        masks[out_stage][o_idx] = 1
        masks[out_stage][o_idx + h] = -1

        sig = sig2 & (h - 1)

    # middle stage: blocks of two, stride 1
    swap_mid = (pos_id & 1 == 0) & (sig == 1)
    masks[b - 1][swap_mid] = 1
    masks[b - 1][pos_id[swap_mid] + 1] = -1
    return masks


def benes_strides(m: int) -> List[int]:
    b = int(np.log2(m))
    down = [m >> (d + 1) for d in range(b - 1)]          # m/2 ... 2
    return down + [1] + down[::-1]


def apply_benes_numpy(masks: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Host simulation of the network: route ``x`` (m,) through ``masks``."""
    m = x.shape[0]
    t = x.copy()
    for k, s in enumerate(benes_strides(m)):
        up = np.roll(t, -(s))     # up[j] = t[j + s]
        dn = np.roll(t, s)        # dn[j] = t[j - s]
        mk = masks[k]
        t = np.where(mk > 0, up, np.where(mk < 0, dn, t))
    return t


def pack_masks(masks: np.ndarray) -> np.ndarray:
    """(L, S, m) int8 {-1,0,1} -> (L, ceil(S/32), m) int32 exchange bits
    (``tpcg/ops/route_spmv.py:49``): the direction of an exchange follows
    from bit s of the position, so only the exchange flag is stored."""
    L, S, m = masks.shape
    W = -(-S // STAGES_PER_WORD)
    ex = (masks != 0).astype(np.uint32)
    out = np.zeros((L, W, m), dtype=np.uint32)
    for k in range(S):
        out[:, k // STAGES_PER_WORD] |= ex[:, k] << (k % STAGES_PER_WORD)
    return out.astype(np.int32)


def unpack_masks(packed: np.ndarray, strides) -> np.ndarray:
    """Inverse of :func:`pack_masks`: exchange bits -> signed int8 masks
    (+1 at the low partner of a pair, -1 at the high one)."""
    packed = np.asarray(packed).astype(np.uint32)
    L, W, m = packed.shape
    S = len(strides)
    pos = np.arange(m)
    masks = np.zeros((L, S, m), dtype=np.int8)
    for k, s in enumerate(strides):
        bit = (packed[:, k // STAGES_PER_WORD]
               >> (k % STAGES_PER_WORD)) & 1
        sign = np.where((pos & s) == 0, 1, -1).astype(np.int8)
        masks[:, k] = bit.astype(np.int8) * sign
    return masks


# ---------------------------------------------------------------------------
# Layer decomposition
# ---------------------------------------------------------------------------

def assign_layers(rows: np.ndarray, cols: np.ndarray, n: int,
                  repair_rounds: int = 6, seed: int = 0
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split nonzeros into matchings (<=1 per row and per column).

    Returns a list of (row_idx, nnz_idx) pairs per layer.  Greedy: each
    round selects, among remaining nonzeros, at most one per row, then
    resolves column conflicts keeping one winner (a few repair rounds let
    losing rows try their next edge inside the same layer).
    """
    rng = np.random.default_rng(seed)
    m = len(rows)
    order = rng.permutation(m)
    # row-sorted working arrays (stable sort keeps the shuffle within
    # rows); compacted after every layer so the cost is O(sum remaining)
    sort_r = np.argsort(rows[order], kind="stable")
    idx_w = order[sort_r]
    rows_w = rows[idx_w]
    cols_w = cols[idx_w]
    layers = []

    while len(idx_w):
        matched = np.zeros(len(idx_w), dtype=bool)
        sel_rows, sel_idx = [], []
        used_col = np.zeros(n, dtype=bool)
        used_row = np.zeros(n, dtype=bool)
        for _ in range(repair_rounds):
            cand_mask = (~matched & ~used_row[rows_w]
                         & ~used_col[cols_w])
            if not cand_mask.any():
                break
            cand_pos = np.where(cand_mask)[0]
            cand_rows = rows_w[cand_pos]
            # first candidate per row
            first = np.ones(len(cand_pos), dtype=bool)
            first[1:] = cand_rows[1:] != cand_rows[:-1]
            cand_pos = cand_pos[first]
            cand_cols = cols_w[cand_pos]
            # column-conflict resolution: keep first per column
            csort = np.argsort(cand_cols, kind="stable")
            cc = cand_cols[csort]
            keep = np.ones(len(cc), dtype=bool)
            keep[1:] = cc[1:] != cc[:-1]
            win = cand_pos[csort[keep]]
            used_col[cols_w[win]] = True
            used_row[rows_w[win]] = True
            matched[win] = True
            sel_rows.append(rows_w[win])
            sel_idx.append(idx_w[win])
        layers.append((np.concatenate(sel_rows), np.concatenate(sel_idx)))
        idx_w = idx_w[~matched]
        rows_w = rows_w[~matched]
        cols_w = cols_w[~matched]
    return layers


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RoutedSpmv:
    """Routing-network tables of one matrix (``tpcg.ops.routing.RoutedSpmv``).

    masks : (L, S, m) int8 Benes switch masks
    vals  : (L, m) float32 (or complex64) values in target (output-row) order
    n     : logical size (m = next power of two, at least 128)
    """
    masks: np.ndarray
    vals: np.ndarray
    n: int

    @property
    def m(self):
        return self.vals.shape[1]

    @property
    def n_layers(self):
        return self.vals.shape[0]

    def save(self, path: str) -> None:
        """Write the tables as JAX does: keys ``packed`` (1-bit masks),
        ``vals`` and ``n``, so either package loads the other's file."""
        np.savez_compressed(path, packed=pack_masks(self.masks),
                            vals=self.vals, n=self.n)

    @classmethod
    def load(cls, path: str) -> "RoutedSpmv":
        z = np.load(path)
        if "masks" in z:                     # JAX's older int8 format
            return cls(masks=z["masks"], vals=z["vals"], n=int(z["n"]))
        vals = z["vals"]
        masks = unpack_masks(z["packed"], benes_strides(vals.shape[1]))
        return cls(masks=masks, vals=vals, n=int(z["n"]))

    def matvec_numpy(self, x: np.ndarray) -> np.ndarray:
        """Host simulation of the routed product (tests)."""
        dt = np.result_type(self.vals.dtype, np.asarray(x).dtype)
        xp = np.zeros(self.m, dtype=dt)
        xp[: self.n] = x
        y = np.zeros(self.m, dtype=dt)
        for l in range(self.n_layers):
            y += self.vals[l] * apply_benes_numpy(self.masks[l], xp)
        return y[: self.n]


def build_routing_spmv(A, seed: int = 0, native: bool = None) -> RoutedSpmv:
    """Preprocess a scipy sparse matrix into routed-layer tables
    (``tpcg.ops.routing.build_routing_spmv``).

    Complex matrices keep complex64 values.  ``native``: use the C++
    table code (``tpcg/native/routing_builder.cpp``, through
    ``tpcg_torch.native.routing_native``) when it builds; the default tries
    it and otherwise runs this module's numpy code, as JAX does.  The two
    decompose into different layers; the product is the same."""
    import scipy.sparse as sp
    A = sp.coo_matrix(A)
    n = A.shape[0]
    vdt = np.complex64 if np.iscomplexobj(A.data) else np.float32
    if native is None or native:
        from ..native import routing_native
        nat = (routing_native.build(A.row, A.col, n, seed=seed)
               if routing_native.available() else None)
        if nat is not None:
            masks, layer, m = nat
            vals = np.zeros((masks.shape[0], m), dtype=vdt)
            vals[layer, A.row] = A.data.astype(vdt)
            return RoutedSpmv(masks=masks, vals=vals, n=n)
        if native:
            raise RuntimeError("native routing-table code unavailable")
    # at least 128: JAX's kernel tiles the routed vector in 128-lane rows
    m = 1 << int(np.ceil(np.log2(max(n, 128))))
    layers = assign_layers(A.row.astype(np.int64), A.col.astype(np.int64),
                           n, seed=seed)
    L = len(layers)
    masks = np.zeros((L, 2 * int(np.log2(m)) - 1, m), dtype=np.int8)
    vals = np.zeros((L, m), dtype=vdt)
    for l, (lrows, lidx) in enumerate(layers):
        lcols = A.col[lidx]
        perm = np.full(m, -1, dtype=np.int64)
        perm[lrows] = lcols                      # out[i] = x[col]
        # complete to a bijection with the unused sources
        free_tgt = np.where(perm < 0)[0]
        used = np.zeros(m, dtype=bool)
        used[lcols] = True
        free_src = np.where(~used)[0]
        perm[free_tgt] = free_src
        masks[l] = benes_masks(perm)
        vals[l, lrows] = A.data[lidx].astype(vdt)
    return RoutedSpmv(masks=masks, vals=vals, n=n)


def routed_to_csr(R: RoutedSpmv):
    """The matrix the tables hold, as ``scipy.sparse.csr_matrix`` (float32,
    or complex64 for complex tables).

    Pushing the index vector ``arange(m)`` through a layer's network gives
    the source column of every target row; the entries kept are those with
    a nonzero value in a row below ``n``.  Entries of one (row, column) in
    several layers are summed.  One host pass over the tables."""
    import scipy.sparse as sp
    n, m = int(R.n), R.m
    idx = np.arange(m, dtype=np.int64)
    rows, cols, vals = [], [], []
    for l in range(R.n_layers):
        src = apply_benes_numpy(R.masks[l], idx)
        v = R.vals[l]
        keep = np.nonzero(v[:n])[0]
        rows.append(keep)
        cols.append(src[keep])
        vals.append(v[keep])
    vdt = np.complex64 if np.iscomplexobj(R.vals) else np.float32
    rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    vals = (np.concatenate(vals) if vals else np.zeros(0)).astype(vdt)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n), dtype=vdt)
