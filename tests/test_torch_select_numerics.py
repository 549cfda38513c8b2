"""A numpy model of the fed_select CUDA kernel's selection, held bitwise to
the plain version on the CPU.

The kernel (``src/repro_torch/kernels/csrc/fed_select.cu``) cannot run
here, so its algorithm is modelled step for step: the order keys (-0.0
canonicalised to +0.0, unavailable clients at -1e30), the layout (each
block owns a contiguous range of tiles; a thread holds 4 consecutive ids
of a tile), four 8-bit radix passes whose per-block histograms are merged
and whose digit a warp picks (lane l looking at digits 255 - 8l down), the
k_eff edges, k_eff - g taken as the rank the last pick leaves (no count of
g), and tie ranks from the earlier blocks' last-pass histograms (less
their unavailable clients when thr is the unavailable key) plus a block
scan of four tiles' counts packed in 16-bit fields.
The launcher's two configurations are modelled with it: one block up to
the crossover, and the cooperative grid (at several grid sizes) above.
Every case must give ``ref.topk_threshold_mask``'s mask byte for byte.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

ITEMS, MAX_THREADS = 4, 1024
SMALL_MAX, SMALL_CAP = 8192, MAX_THREADS * ITEMS * 4   # fed_select.cu


def order_keys(scores, avail):
    s = np.where(avail, scores, np.float32(-1e30)).astype(np.float32)
    u = s.view(np.uint32).copy()
    u[u == 0x80000000] = 0                               # -0.0 -> +0.0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def small_config(n):
    """(blocks, threads, tiles) of the one-block path, as the launcher."""
    threads = -(-n // ITEMS)
    threads = -(-threads // 32) * 32 if threads < MAX_THREADS else MAX_THREADS
    return 1, threads, -(-n // (ITEMS * threads))


def large_config(n, grid_max):
    """(blocks, threads, tiles) of the cooperative path, as the launcher."""
    tiles_total = -(-n // (ITEMS * MAX_THREADS))
    tiles = -(-tiles_total // grid_max)
    return -(-tiles_total // tiles), MAX_THREADS, tiles


def pick_digit(hist, k_rem):
    """Warp 0's pick: lane l sums digits 255 - 8l .. 248 - 8l, the first
    lane whose inclusive sum reaches k_rem walks its eight digits down."""
    c = hist[::-1].reshape(32, 8).sum(axis=1)
    incl = np.cumsum(c)
    hits = np.nonzero(incl >= k_rem)[0]
    lane = int(hits[0]) if len(hits) else 31
    cum, top = int(incl[lane] - c[lane]), 255 - 8 * lane
    i = 0                        # the lane's last digit if no other
    while i < 7 and cum + hist[top - i] < k_rem:
        cum += int(hist[top - i])
        i += 1
    return top - i, k_rem - cum


def model_mask(scores, avail, k, blocks, threads, tiles):
    n = len(scores)
    assert blocks * tiles * threads * ITEMS >= n
    b, t, x, j = np.meshgrid(np.arange(blocks), np.arange(tiles),
                             np.arange(threads), np.arange(ITEMS),
                             indexing="ij")
    ids = ((b * tiles + t) * ITEMS * threads + ITEMS * x + j).astype(np.int64)
    valid = ids < n
    safe = np.minimum(ids, n - 1)
    key = np.where(valid, order_keys(scores, avail)[safe], 0).astype(np.uint64)
    av = valid & avail[safe]

    k_rem = min(max(int(k), 0), int(av.sum()))          # k_eff
    prefix = 0
    for shift in (24, 16, 8, 0):
        hmask = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        match = valid & ((key & hmask) == prefix)
        digits = ((key >> shift) & 0xFF).astype(np.int64)
        per_block = [np.bincount(digits[i][match[i]], minlength=256)
                     for i in range(blocks)]
        d, k_rem = pick_digit(sum(per_block), k_rem)   # merged histogram
        prefix |= d << shift
    thr = prefix
    quota = k_rem                                       # k_eff - g

    # each block's ties: its last-pass count in thr's bin, less its
    # unavailable clients when thr is their key
    unavail_key = int(order_keys(np.float32([0]), np.zeros(1, bool))[0])
    block_unavail = (valid & ~av).sum(axis=(1, 2, 3))
    block_ties = [int(per_block[i][thr & 0xFF])
                  - (int(block_unavail[i]) if thr == unavail_key else 0)
                  for i in range(blocks)]
    eq = av & (key == thr)
    mask = np.zeros(n, bool)
    for blk in range(blocks):
        carry = sum(block_ties[:blk])
        for t0 in range(0, tiles, 4):
            group = range(t0, min(t0 + 4, tiles))
            packed = np.zeros(threads, np.uint64)
            for tt in group:
                packed |= (eq[blk, tt].sum(axis=1).astype(np.uint64)
                           << np.uint64(16 * (tt - t0)))
            excl = np.cumsum(packed) - packed            # the block scan
            total = int(packed.sum())
            for tt in group:
                f = 16 * (tt - t0)
                base = carry + ((excl >> np.uint64(f)) & np.uint64(0xFFFF))
                carry += (total >> f) & 0xFFFF
                e = eq[blk, tt]
                rank = base.astype(np.int64)[:, None] + np.cumsum(e, 1) - e
                sel = av[blk, tt] & ((key[blk, tt] > thr)
                                     | (e & (rank < quota)))
                ok = valid[blk, tt]
                mask[ids[blk, tt][ok]] = sel[ok]
    return mask


def case(n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":   # 8 levels, both zeros among them
        levels = np.array([-1.5, -0.0, 0.0, 0.25, 0.5, 1.0, 2.0, 3.0],
                          np.float32)
        scores = levels[rng.integers(0, 8, n)]
    else:
        scores = rng.normal(size=n).astype(np.float32)
    if kind == "sentinel":   # available clients at and below -1e30
        scores[rng.random(n) < 0.1] = np.float32(-1e30)
        scores[rng.random(n) < 0.05] = -np.inf
    q = {"none": 0.0, "all": 1.0}.get(kind, 0.5)
    return scores, rng.random(n) < q


def want_mask(scores, avail, k):
    return ref.topk_threshold_mask(torch.from_numpy(scores),
                                   torch.from_numpy(avail),
                                   torch.tensor(k, dtype=torch.int32)).numpy()


# (n, kind, k): random, heavy ties, k = 0, k = 1, k >= |avail|, nobody
# available, everyone available with k = n; N at and around the crossover.
# With half the clients available, k = 0.7 |avail| puts the cut among the
# zeros of the tie levels, where -0.0 and +0.0 must tie.  "sentinel": with
# k = N the cut lands on -1e30 or -inf, the unavailable clients' key or
# below it.
CASES = [(100, "normal", 10), (100, "ties", 35), (100, "normal", 0),
         (100, "normal", 1), (100, "normal", 100), (100, "none", 17),
         (100, "all", 100), (SMALL_MAX - 1, "ties", 2867),
         (SMALL_MAX, "normal", 1234), (SMALL_MAX + 1, "ties", 999),
         (SMALL_CAP, "normal", 5000), (70_001, "normal", 5000),
         (70_001, "ties", 12_345), (200_003, "normal", 0),
         (200_003, "ties", 70_000), (200_003, "none", 7),
         (200_003, "all", 200_003), (200_003, "normal", 1),
         (100, "sentinel", 100), (SMALL_MAX + 1, "sentinel", SMALL_MAX + 1),
         (200_003, "sentinel", 200_003), (200_003, "sentinel", 97_000)]


@pytest.mark.parametrize("n,kind,k", [c for c in CASES if c[0] <= SMALL_CAP])
def test_one_block_model_is_the_plain_cut(n, kind, k):
    scores, avail = case(n, n + k, kind)
    got = model_mask(scores, avail, k, *small_config(n))
    assert got.tobytes() == want_mask(scores, avail, k).tobytes()


@pytest.mark.parametrize("grid_max", (7, 132, 264))
@pytest.mark.parametrize("n,kind,k", CASES)
def test_grid_model_is_the_plain_cut(n, kind, k, grid_max):
    scores, avail = case(n, n + k, kind)
    blocks, threads, tiles = large_config(n, grid_max)
    assert blocks <= grid_max
    got = model_mask(scores, avail, k, blocks, threads, tiles)
    assert got.tobytes() == want_mask(scores, avail, k).tobytes()


def test_layouts_cover_every_id_once():
    """The launcher's configurations put each id in exactly one (block,
    tile, thread, item) slot, and a grid of 7 spreads N = 200,003 over
    more than four tiles a block (two packed scans)."""
    for n, cfg in ((100, small_config(100)), (SMALL_CAP, small_config(
            SMALL_CAP)), (200_003, large_config(200_003, 7))):
        blocks, threads, tiles = cfg
        b, t, x, j = np.meshgrid(np.arange(blocks), np.arange(tiles),
                                 np.arange(threads), np.arange(ITEMS),
                                 indexing="ij")
        ids = ((b * tiles + t) * ITEMS * threads + ITEMS * x + j).ravel()
        ids = ids[ids < n]
        assert np.array_equal(np.sort(ids), np.arange(n))
    assert large_config(200_003, 7)[2] > 4
    assert small_config(100) == (1, 32, 1)


def test_zero_canonicalisation_and_digit_pick_edges():
    """-0.0 and +0.0 share a key (the reference compares with ==); a cut
    of 0 picks digit 255 in every pass, so thr = 0xFFFFFFFF."""
    k = order_keys(np.array([-0.0, 0.0, -1.0, 1.0], np.float32),
                   np.ones(4, bool))
    assert k[0] == k[1] and k[2] < k[0] < k[3]
    hist = np.zeros(256, np.int64)
    hist[3] = 10
    assert pick_digit(hist, 0) == (255, 0)
    assert pick_digit(hist, 10) == (3, 10)
    hist[200] = 5
    assert pick_digit(hist, 6) == (3, 1)
