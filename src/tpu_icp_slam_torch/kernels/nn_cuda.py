"""K1: exact brute-force nearest neighbour — CUDA kernel and plain version.

`nn_bruteforce(src, dst)` launches csrc/nn_bruteforce.cu on CUDA tensors
(the port of tpu_icp_slam/kernels/nn_pallas.py::_nn_kernel, "highest" mode)
and runs `nn_bruteforce_ref` on CPU tensors. Both select by the exact
difference form Σ(a-b)² and break ties toward the lowest index; see the
kernel source for how that relates to the reference's factored form.

Points are 3-D or 2-D (D = 2: the 2D lidar pipelines; the kernel takes D as
a template parameter, and its 2-D results equal the plain version's bit for
bit).

Batched form (loop-closure verification, the reference's vmap over align):
src (B, M, D) and dst (B/G, N, D); source b is searched in target b // G,
so G consecutive batch rows share one target. One launch serves the whole
batch, and each element gives what the unbatched call gives on it.

Two scans on the card, chosen by the input alone:
  - the unbatched call (D = 2 or 3: the front end's search) and the
    batched call at D = 2 run `nn_split_kernel<D>`, which scores every pair
    in the difference form (3 FSUB, FMUL, 2 FFMA and an FMNMX: 7
    instructions a pair);
  - the batched call at D = 3 (loop verification) runs
    `nn_split_kernel_factored`: the factored score ‖b‖² − 2a·b (3 FFMA and
    an FMNMX: 4 instructions a pair) as a filter, a rigorous float32 error
    bound that rules runs of 32 targets out, and the difference form again
    on every run the bound keeps, so that idx and d2 are the first scan's
    bit for bit. A row whose kept runs overflow its slots rescans its whole
    split; padded rows (the 1e6 sentinel), which repeat their block's last
    row, share one exact scan of the split; in a block with any other far
    row, or a norm beyond the bound's range, every row rescans its whole
    split. The source note derives the bound. The split by form is one of
    scope: the factored scan has not been timed on the unbatched call, so
    the front end keeps the first scan until a run measures it there.
`nn_factored_ref` is the second scan's selection in plain torch (the
filter, the bound, the rescans and their counts), held in the CPU tests to
K1's chain bit for bit. The card counts each launch's COUNTS in a buffer
that a captured trip keeps (`scan_counts` reads it, one sync).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_icp_slam_torch.kernels import _build


def _nn_one(src: torch.Tensor, dst: torch.Tensor, chunk: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    idx_out, d2_out = [], []
    for a in torch.split(src, chunk):
        # Σ (a_k - b_k)² summed in coordinate order, one rounding a step
        diff = a[:, None, 0] - dst[None, :, 0]
        d = diff * diff  # (chunk, N)
        for k in range(1, src.shape[-1]):
            diff = a[:, None, k] - dst[None, :, k]
            d = d + diff * diff
        d2, idx = torch.min(d, dim=1)  # first minimum on ties
        idx_out.append(idx.to(torch.int32))
        d2_out.append(d2)
    return torch.cat(idx_out), torch.cat(d2_out)


def nn_bruteforce_ref(src: torch.Tensor, dst: torch.Tensor,
                      chunk: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch: (M, D), (N, D) f32 -> (idx (M,) int32, d2 (M,) f32),
    over (chunk, N) distance tiles; batched (B, M, D), (B/G, N, D) ->
    (B, M) element by element."""
    if src.dim() == 2:
        return _nn_one(src, dst, chunk)
    group = src.shape[0] // dst.shape[0]
    out = [_nn_one(s, dst[b // group], chunk) for b, s in enumerate(src)]
    return (torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


# Grid constants of csrc/nn_bruteforce.cu (kBlockRows, kSplitAlign).
_BLOCK_ROWS = 1024
_SPLIT_ALIGN = 4
_MIN_SPLIT = 256  # fewest targets a split is cut to
_BLOCK_OVERHEAD = 64  # a block's staging, rescan and store, in targets


# ---- the batched 3-D scan: factored filter, certified exact selection ----
#
# Constants of csrc/nn_bruteforce.cu's nn_split_kernel_factored (kRun,
# kSlots, kCB, kCHi, kCA, kCE, kEta, kRange, kFar); the source note there
# derives them.
RUN = 32  # targets a run
SLOTS = 4  # kept runs a row holds besides its newest
_U = 2.0 ** -24  # unit roundoff of float32
C_B = 9.0 * _U * (1.0 + 2.0 ** -12)  # of a target's ‖b‖²
C_HI = 3.0 * C_B  # of a run's largest ‖b‖², for its upper score
C_A = 3.0 * _U * (1.0 + 2.0 ** -12)  # of the row's ‖a‖²
C_E = 10.0 * _U * (1.0 + 2.0 ** -12)  # of the best distance: two chains
ETA = 2.0 ** -60  # absolute room for subnormal results
RANGE = 2.0 ** 100  # a target's squared norm at or above it: no filter
FAR = 2.0 ** 32  # a row's squared norm at or above it keeps no run
_SLACK = 2.0 ** -40  # room for this version's own float64 bound arithmetic
# What the scan counts: runs rescanned in the difference form; rows; rows
# that rescanned their whole split (overflowed slots, or a block that
# dropped the filter); far rows that took their block's last row's pick.
COUNTS = ("runs_rescanned", "rows", "fallback_rows", "shared_rows")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, b, c): the product exact in float64, the sum rounded
    there and then to float32."""
    return (a.double() * b.double() + c.double()).float()


def sq_norm_chain(p: torch.Tensor) -> torch.Tensor:
    """(n, 3) -> (n,) float32 fma(z, z, fma(y, y, x·x)), the kernel's
    squared norm."""
    return _fma(p[:, 2], p[:, 2], _fma(p[:, 1], p[:, 1], p[:, 0] * p[:, 0]))


def k1_scores(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, 3), (n, 3) -> (m, n): K1's exact chain dx·dx, then fma(dy, dy,
    .), then fma(dz, dz, .), with the differences rounded to float32."""
    dx, dy, dz = (a[:, None, k] - b[None, :, k] for k in range(3))
    return _fma(dz, dz, _fma(dy, dy, dx * dx))


def factored_scores(a: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """(m, 3), (n, 3), (n,) -> (m, n): the filter's score w − 2a·b as
    fma(−2ax, bx, fma(−2ay, by, fma(−2az, bz, w))), where the kernel stages
    w = ‖b‖² − C_B·‖b‖² rounded down (`lowered_norms`)."""
    m2 = -2.0 * a
    return _fma(m2[:, None, 0], b[None, :, 0],
                _fma(m2[:, None, 1], b[None, :, 1],
                     _fma(m2[:, None, 2], b[None, :, 2], w[None, :])))


def lowered_norms(nb: torch.Tensor) -> torch.Tensor:
    """float32 nb − C_B·nb rounded down, one ulp lower still for the
    rounding of this version's float64 product (the kernel's
    __fmaf_rd(−kCB, nb, nb) is exact up to its one rounding)."""
    x = nb.double() * (1.0 - C_B)
    w = x.float()
    w = torch.where(w.double() > x, torch.nextafter(w, -w.abs() - 1), w)
    return torch.nextafter(w, torch.full_like(w, -torch.inf))


def _rescan(a: torch.Tensor, b: torch.Tensor, starts: torch.Tensor,
            live: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Runs [starts, starts + RUN) of b (clipped at its end), one a slot:
    (rows, S) -> (least exact score, the first target that has it), +inf
    and -1 where the slot is not live."""
    t = starts[..., None] + torch.arange(RUN)  # (rows, S, RUN)
    inside = (t < b.shape[0]) & live[..., None]
    q = b[torch.clamp(t, max=b.shape[0] - 1)]  # (rows, S, RUN, 3)
    dx, dy, dz = (a[:, None, None, k] - q[..., k] for k in range(3))
    d = _fma(dz, dz, _fma(dy, dy, dx * dx))
    d = torch.where(inside & ~torch.isnan(d), d, torch.inf)
    e, j = torch.min(d, dim=2)  # the first of equal minima
    return e, torch.where(live, starts + j, -1)


def _threshold(v: torch.Tensor, e_a: torch.Tensor,
               na_up: torch.Tensor) -> torch.Tensor:
    """The filter's bound on a run's lower score from the row's best upper
    score v: v + 2·eA + C_E·max(0, v + eA + ‖a‖²) + ETA, widened by this
    version's float64 rounding."""
    t = v + 2.0 * e_a + C_E * torch.clamp(v + e_a + na_up, min=0.0) + ETA
    return t + _SLACK * (v.abs() + t.abs())


def _factored_split(a: torch.Tensor, b: torch.Tensor, counts: list
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One split of the batched 3-D scan: the rows of one block, a (m, 3),
    against the split's targets b (L, 3) -> (least exact score (m,), its
    first target (m,)), as nn_split_kernel_factored selects them. counts +=
    COUNTS."""
    m, n = a.shape[0], b.shape[0]
    runs = -(-n // RUN)
    pad = runs * RUN - n
    na = sq_norm_chain(a).double()
    nb = sq_norm_chain(b)
    # a far row that repeats the block's last row bit for bit takes an
    # exact scan of the split (once, for all of them); a block with any
    # other far row, or a split with a norm outside the bound's range,
    # drops the filter: every row takes an exact scan of the split
    far = ~(na < FAR)
    same = (a.view(torch.int32) == a[-1].view(torch.int32)).all(dim=1)
    exact = bool((far & ~same).any()) or not bool((nb < RANGE).all())
    over = far | exact  # rows that take an exact scan of the split
    slot_lo = torch.full((m, SLOTS), torch.inf, dtype=torch.float64)
    slot_start = torch.zeros((m, SLOTS), dtype=torch.int64)
    cnt = torch.zeros(m, dtype=torch.int64)
    thr = torch.full((m,), torch.inf, dtype=torch.float64)
    last_lo = torch.full((m,), torch.inf, dtype=torch.float64)  # newest
    last_start = torch.zeros(m, dtype=torch.int64)
    thr[far] = -torch.inf  # keeps no run
    if not exact and not bool(far.all()):
        f = torch.nn.functional.pad(
            factored_scores(a, b, lowered_norms(nb)), (0, pad),
            value=torch.inf)
        lo = f.view(m, runs, RUN).amin(dim=2).double()  # each run's least
        hi = lo + C_HI * torch.nn.functional.pad(nb, (0, pad)).view(
            runs, RUN).amax(dim=1).double()
        hi = hi + _SLACK * hi.abs()
        e_a = C_A * na
        na_up = na * (1.0 + 2.0 ** -21)
        for r in range(runs):
            cand = lo[:, r] <= thr
            if not bool(cand.any()):
                continue
            thr = torch.where(cand, torch.minimum(
                thr, _threshold(hi[:, r], e_a, na_up)), thr)
            # the newest kept run waits apart; the one before it goes to
            # the slots only if the bound still keeps it
            push = cand & (last_lo <= thr) & ~over
            if bool(push.any()):
                full = push & (cnt == SLOTS)
                if bool(full.any()):
                    # drop what the bound now rules out, keeping index order
                    keep = slot_lo <= thr[:, None]
                    order = torch.sort((~keep).to(torch.int8), dim=1,
                                       stable=True).indices
                    slot_lo = torch.where(full[:, None],
                                          torch.gather(slot_lo, 1, order),
                                          slot_lo)
                    slot_start = torch.where(
                        full[:, None], torch.gather(slot_start, 1, order),
                        slot_start)
                    cnt = torch.where(full, keep.sum(dim=1), cnt)
                    over |= full & (cnt == SLOTS)  # no slot left
                    push &= ~over
                put = push[:, None] & (torch.arange(SLOTS) == cnt[:, None])
                slot_lo = torch.where(put, last_lo[:, None], slot_lo)
                slot_start = torch.where(put, last_start[:, None],
                                         slot_start)
                cnt = cnt + push.to(torch.int64)
            last_lo = torch.where(cand, lo[:, r], last_lo)
            last_start = torch.where(cand, r * RUN, last_start)

    # the slots, then the newest, each if the final bound keeps it
    kept_lo = torch.cat([slot_lo, last_lo[:, None]], dim=1)
    filled = torch.cat([torch.arange(SLOTS) < cnt[:, None],
                        (last_lo < torch.inf)[:, None]], dim=1)
    live = filled & (kept_lo <= thr[:, None]) & ~over[:, None]
    e, j = _rescan(a, b, torch.cat([slot_start, last_start[:, None]], dim=1),
                   live)
    best = torch.full((m,), torch.inf)
    best_j = torch.zeros(m, dtype=torch.int64)  # the split's first
    for s in range(SLOTS + 1):  # in index order, strict <
        take = live[:, s] & (e[:, s] < best)
        best = torch.where(take, e[:, s], best)
        best_j = torch.where(take, j[:, s], best_j)
    if bool(over.any()):
        d = k1_scores(a[over], b)
        d = torch.where(torch.isnan(d), torch.inf, d)
        e_w, j_w = torch.min(d, dim=1)  # the first of equal minima
        best[over] = e_w
        best_j[over] = torch.where(e_w < torch.inf, j_w, 0)
    counts[0] += int(live.sum())
    counts[1] += m
    counts[2] += m if exact else int((over & ~far).sum())
    counts[3] += 0 if exact else int(far.sum())
    return best, best_j


def split_length(n: int, n_split: int) -> int:
    """Targets a split of K1's grid covers (nn_bruteforce_f32's L)."""
    return -(-(-(-n // n_split)) // _SPLIT_ALIGN) * _SPLIT_ALIGN


def nn_factored_ref(src: torch.Tensor, dst: torch.Tensor, n_split: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor, list]:
    """Plain torch version of the batched 3-D scan's selection: (M, 3),
    (N, 3) f32 -> (idx (M,) int32, d2 (M,) f32, [COUNTS]); batched
    (B, M, 3), (B/G, N, 3) -> (B, M). The target
    axis is cut into n_split splits as the kernel's grid cuts it, each
    split's pick folded in order with a strict `<`. idx and d2 are K1's
    (the first minimum of its exact chain, `k1_scores`) bit for bit; the
    counts follow the kernel's rule, not its float32 bound arithmetic."""
    if src.dim() == 3:
        group = src.shape[0] // dst.shape[0]
        out = [nn_factored_ref(s, dst[i // group], n_split)
               for i, s in enumerate(src)]
        counts = [sum(o[2][k] for o in out) for k in range(len(COUNTS))]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]), counts)
    n = dst.shape[0]
    length = split_length(n, n_split)
    counts = [0] * len(COUNTS)
    idx_out, d2_out = [], []
    for a in torch.split(src, _BLOCK_ROWS):  # the kernel's row blocks
        best = torch.full((a.shape[0],), torch.inf)
        best_j = torch.zeros(a.shape[0], dtype=torch.int64)
        for j0 in range(0, n, length):
            e, j = _factored_split(a, dst[j0:j0 + length], counts)
            take = e < best
            best = torch.where(take, e, best)
            best_j = torch.where(take | (j0 == 0), j + j0, best_j)
        idx_out.append(best_j.to(torch.int32))
        d2_out.append(best)
    return torch.cat(idx_out), torch.cat(d2_out), counts


@functools.cache
def blocks_per_sm(index: int, dim: int = 3, factored: bool = False) -> int:
    """Blocks of K1's split kernel for dim-D points (with `factored`, of the
    batched 3-D scan) that one SM of CUDA device `index` holds at once,
    read once."""
    out = ctypes.c_int(0)
    lib = _build.load()
    with torch.cuda.device(index):
        if factored:
            _build.check(lib.nn_bruteforce_factored_blocks_per_sm(
                ctypes.addressof(out)), "nn_bruteforce_factored_blocks_per_sm")
        else:
            _build.check(lib.nn_bruteforce_blocks_per_sm(
                dim, ctypes.addressof(out)), "nn_bruteforce_blocks_per_sm")
    return max(1, out.value)


_counts: dict = {}  # device index -> the batched 3-D scan's int64 (4,)


def _counts_buffer(device: torch.device) -> torch.Tensor:
    """The device's count buffer, which every launch of the batched 3-D
    scan adds to on the card (a captured trip keeps its address). It is
    made by the first such launch, which must not be inside a capture."""
    buf = _counts.get(device.index)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "nn_bruteforce: the first batched 3-D search on a device "
                "runs outside a CUDA graph capture (it makes the count "
                "buffer)")
        buf = _counts[device.index] = torch.zeros(len(COUNTS),
                                                  dtype=torch.int64,
                                                  device=device)
    return buf


def scan_counts() -> dict:
    """The batched 3-D scan's COUNTS since the last reset, summed over the
    devices and read to the host (a sync), each row counted once a
    split."""
    vals = [0] * len(COUNTS)
    for buf in _counts.values():
        vals = [v + int(x) for v, x in zip(vals, buf.tolist())]
    return dict(zip(COUNTS, vals))


def reset_scan_counts() -> None:
    for buf in _counts.values():
        buf.zero_()


@functools.lru_cache(maxsize=256)
def n_split(m: int, n: int, batch: int, sms: int, resident: int) -> int:
    """Target-axis splits of K1's grid, each a multiple of _SPLIT_ALIGN
    targets and none empty. Among the counts that give at least three
    blocks per SM (and splits of at least _MIN_SPLIT targets), the one with
    the least modelled time: the blocks the busiest SM runs (rounded up to
    whole waves of `resident` once they do not fit at once) times a block's
    targets plus _BLOCK_OVERHEAD, the fewest splits on a tie."""
    items = -(-m // _BLOCK_ROWS) * batch
    s_max = max(1, -(-n // _MIN_SPLIT))
    s_lo = min(max(1, -(-3 * sms // items)), s_max)

    def length(s: int) -> int:
        return -(-(-(-n // s)) // _SPLIT_ALIGN) * _SPLIT_ALIGN

    def cost(s: int) -> int:
        per_sm = -(-(items * s) // sms)
        if per_sm > resident:
            per_sm = resident * -(-per_sm // resident)
        return per_sm * (length(s) + _BLOCK_OVERHEAD)

    s = min(range(s_lo, s_max + 1), key=lambda s: (cost(s), s))
    return -(-n // length(s))


def nn_bruteforce(src: torch.Tensor, dst: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(M, D), (N, D) f32 -> (idx (M,) int32, d2 (M,) f32), D = 2 or 3: the
    nearest dst point of every src point; batched (B, M, D), (B/G, N, D) ->
    (B, M). CPU tensors take the plain version."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return nn_bruteforce_ref(src, dst)
    batched = src.dim() == 3
    if batched:
        _build.require_batched_points("nn_bruteforce", src, dst, dims=(2, 3))
        batch, group = src.shape[0], src.shape[0] // dst.shape[0]
    else:
        _build.require_points("nn_bruteforce", (2, 3), src=src, dst=dst)
        batch, group = 1, 1
    m, n, dim = src.shape[-2], dst.shape[-2], src.shape[-1]
    lib = _build.load()
    factored = batched and dim == 3  # the batched 3-D scan
    s = n_split(m, n, batch, _build.sm_count(src.device.index),
                blocks_per_sm(src.device.index, dim, factored))
    lead = src.shape[:-2]
    part_d2 = torch.empty((batch, s, m), dtype=torch.float32,
                          device=src.device)
    part_idx = torch.empty((batch, s, m), dtype=torch.int32,
                           device=src.device)
    d2 = torch.empty((*lead, m), dtype=torch.float32, device=src.device)
    idx = torch.empty((*lead, m), dtype=torch.int32, device=src.device)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    if factored:
        err = lib.nn_bruteforce_factored_f32(
            src.data_ptr(), dst.data_ptr(), batch, group, m, n, s,
            part_d2.data_ptr(), part_idx.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), _counts_buffer(src.device).data_ptr(), stream)
        _build.check(err, "nn_bruteforce_factored_f32")
    else:
        err = lib.nn_bruteforce_f32(
            src.data_ptr(), dst.data_ptr(), batch, group, m, n, dim, s,
            part_d2.data_ptr(), part_idx.data_ptr(), d2.data_ptr(),
            idx.data_ptr(), stream)
        _build.check(err, "nn_bruteforce_f32")
    nn_bruteforce.launches += 1
    nn_bruteforce.batched_launches += batched
    nn_bruteforce.launches_2d += dim == 2
    return idx, d2


nn_bruteforce.launches = 0  # every launch
nn_bruteforce.batched_launches = 0  # launches of the batched form
nn_bruteforce.launches_2d = 0  # launches on 2-D points, either form


def difference_scan(src: torch.Tensor, dst: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first scan (nn_split_kernel<D>) on CUDA tensors whatever the
    form: for a batched 3-D call, what `nn_bruteforce` launched before the
    factored scan, which it must equal bit for bit (the card's A/B). Not on
    the main path; counts no launch."""
    batched = src.dim() == 3
    if batched:
        _build.require_batched_points("difference_scan", src, dst,
                                      dims=(2, 3))
        batch, group = src.shape[0], src.shape[0] // dst.shape[0]
    else:
        _build.require_points("difference_scan", (2, 3), src=src, dst=dst)
        batch, group = 1, 1
    m, n, dim = src.shape[-2], dst.shape[-2], src.shape[-1]
    s = n_split(m, n, batch, _build.sm_count(src.device.index),
                blocks_per_sm(src.device.index, dim))
    part_d2 = torch.empty((batch, s, m), dtype=torch.float32,
                          device=src.device)
    part_idx = torch.empty((batch, s, m), dtype=torch.int32,
                           device=src.device)
    d2 = torch.empty(src.shape[:-1], dtype=torch.float32, device=src.device)
    idx = torch.empty(src.shape[:-1], dtype=torch.int32, device=src.device)
    _build.check(_build.load().nn_bruteforce_f32(
        src.data_ptr(), dst.data_ptr(), batch, group, m, n, dim, s,
        part_d2.data_ptr(), part_idx.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream),
        "nn_bruteforce_f32")
    return idx, d2
