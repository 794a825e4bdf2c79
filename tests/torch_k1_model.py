"""A numpy model of how the CUDA kernel K1 (``cronsun_tpu_torch/csrc/
bid_argmin.cu``) walks a row, for the CPU tests: node tiles with the
carried (best, priority), the per-tile candidate masks, each lane's words in
order (lane l takes words l, l+32, ...), the pruning of set bits whose load
exceeds the lane's running best, taken ``BATCH`` bits a step, and the
lexicographic reduction over the warp's lanes.  Scalar and slow: for small tiles only.
"""

import numpy as np

HASH_A, HASH_B, HASH_C, HASH_D = (np.uint32(2654435761), np.uint32(40503),
                                  np.uint32(2246822519), np.uint32(3266489917))
NONE = 0xFFFFFFFF
BATCH = 4                            # kBatch
MAX_WHOLE_WORDS, TILE_WORDS = 384, 256
TIE_MAX = np.float32(65535.0 / 65536.0)
INF = np.float32(np.inf)


def tie_from_bits(v: np.ndarray) -> np.ndarray:
    """float(v) / 65536 for 16-bit v, as the kernel converts it: v in the
    mantissa of 1.0f, minus 1.0f."""
    v = np.asarray(v, np.uint32)
    return (np.uint32(0x3F800000) | (v << np.uint32(7))).view(np.float32) \
        - np.float32(1.0)


def tie(j: int, n: int) -> np.float32:
    with np.errstate(over="ignore"):
        h = (np.uint32(j) * HASH_A) ^ (np.uint32(n) * HASH_B)
        h = h * HASH_C
        h = h ^ (h >> np.uint32(15))
        h = h * HASH_D
    return tie_from_bits(h >> np.uint32(16))


def _set_bits(word: int):
    return [b for b in range(32) if (word >> b) & 1]


def k1_model(packed, load, rows=None, active=None, tile=None):
    """(best [K] f32, choice [K] int32) as the kernel computes them.

    packed: [J, W32] uint32; load: [W32*32] f32; rows: optional [K] ints
    (row j is packed[rows[j]]); active: optional [K] bool; tile: node tile
    width in words (default: the kernel's choice)."""
    packed = np.asarray(packed, np.uint32)
    load = np.asarray(load, np.float32)
    w32 = packed.shape[1]
    K = packed.shape[0] if rows is None else len(rows)
    if tile is None:
        tile = w32 if -(-w32 // 32) * 32 <= MAX_WHOLE_WORDS else TILE_WORDS
    best = np.full(K, INF, np.float32)
    prio = np.full(K, NONE, np.int64)
    for w0 in range(0, w32, tile):
        tw = min(tile, w32 - w0)
        lt = load[w0 * 32:(w0 + tw) * 32].reshape(tw, 32)     # [word, bit]
        mins = lt.min(axis=0)                                  # per plane
        fin = mins[mins < INF]
        theta = fin.max() if len(fin) else -INF
        upper = np.float32(theta + TIE_MAX)
        weights = np.uint32(1) << np.arange(32, dtype=np.uint32)

        def mask(sel):
            return (sel * weights).sum(axis=1).astype(np.uint32)

        hit_m, cand_m, open_m = mask(lt <= theta), mask(lt <= upper), \
            mask(lt < INF)
        for j in range(K):
            if active is not None and not active[j]:
                continue
            r = j if rows is None else int(rows[j])
            words = packed[r, w0:w0 + tw]
            narrow = bool((words & hit_m).any())
            words = words & (cand_m if narrow else open_m)
            lanes = [[best[j], prio[j]] for _ in range(32)]

            def consider(st, l, b, w):
                s = np.float32(l + tie(j, (w0 + w) * 32 + b))
                p = b * w32 + w0 + w
                if s < INF and (s < st[0] or (s == st[0] and p < st[1])):
                    st[0], st[1] = s, p

            for lane in range(32):
                st = lanes[lane]
                stream = [(w, b) for w in range(lane, tw, 32)
                          for b in _set_bits(int(words[w]))]
                for i in range(0, len(stream), BATCH):
                    step = stream[i:i + BATCH]
                    ls = [lt[w, b] for w, b in step]
                    if min(ls) <= st[0]:
                        for (w, b), l in zip(step, ls):
                            consider(st, l, b, w)
            s, p = min((float(st[0]), int(st[1])) for st in lanes)
            best[j], prio[j] = np.float32(s), p
    choice = np.where(prio == NONE, 0, (prio % w32) * 32 + prio // w32)
    return best, choice.astype(np.int32)
