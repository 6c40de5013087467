"""What a compositor kernel must do on a stream: one table of the fp32
operations per (entry, pixel) pair for the whole compositor family (kernels
3, 4 and 4b, the ablation kernels of csrc/fwd_ablate.cu and
csrc/bwd_ablate.cu, and the pair-math probe csrc/mxu_probe.cu), the pairs a
stream needs, the H100's peaks, and the issue floor a kernel's SASS sets.
chip_smoke.py and the tools (exp_fwd_ablate, exp_bwd2, exp_bwd3, exp_mxu)
take their bounds from here.

Counting: each add, multiply, min, max, compare, and the and of two
compares is one operation, expf four; a select of one of two values is not
counted, nor are terms made once per entry or once per pixel and
sub-block (under 1/8 of an operation a pair). The pairs a kernel needs are
those before each 32-pixel strip of a tile is done (a done pixel adds
nothing: kernel 3's warps stop there, and kernels 4 and 4b skip a done
strip's pairs), unless a variant's own function needs every pair.
"""
from __future__ import annotations

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 (non-tensor-
# core) operations/s, bf16 and TF32 tensor-core FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
# The issue floor: one warp instruction per scheduler and cycle, 4
# schedulers on each of the H100 SXM's 132 SMs, at the SM clock nvidia-smi
# gives as clocks.max.sm on the card (1,980 MHz; the clock under load is
# not measured).
SMS, SCHEDULERS, WARP = 132, 4, 32
MAX_SM_CLOCK_HZ = 1.98e9


def issue_floor_ms(instructions_per_pair: float, pairs: int,
                   clock_hz: float = MAX_SM_CLOCK_HZ) -> float:
    """The least time a kernel that issues `instructions_per_pair` SASS
    instructions per (entry, pixel) pair (a thread's, so 1/32 of a warp
    instruction) takes for `pairs` pairs: pairs × instructions / (SMs ×
    schedulers × 32 lanes × clock). It stands beside a bound and replaces
    none."""
    return (pairs * instructions_per_pair
            / (SMS * SCHEDULERS * WARP * clock_hz) * 1e3)

# What a backward recomputes, as composite_fwd.cu does it: 2 pixel
# offsets, 9 for the power, 4 for expf, 1 for o·g, 5 for the mask's two
# compares and their and, the clamp and 1−α, ~4 for the prefix product (129
# products per 32 entries), 3 for t_after and alive (a product, a compare,
# an and), 2 for w (α·T·cum_excl, which alive selects), 1 for the T minimum.
RECOMPUTE_PER_PAIR = 2 + 9 + 4 + 1 + 5 + 4 + 3 + 2 + 1         # 31
# The forward adds 10 for the five colour multiply-adds (kernel 3, and
# fwd_ablate.cu's composite_sub_staged).
OPS_PER_PAIR = RECOMPUTE_PER_PAIR + 10                        # 41
# Kernel 4 (composite_bwd.cu) adds, with NF colour columns (5, or 3 under
# image_only): 2·NF−1 for φ, 3 for T_i, T_i·φ and w·φ, ~4 for the w·φ
# prefix (129 adds per 32 entries), 7 for dα and dpower (S's add and
# subtract, the divide, T_i·φ − S/(1−α), the and of alive and the mask, the
# compare α_raw < 0.99, dα·α), 5 for the moment terms (dp·x and dp·y, then
# dp·x·x, dp·x·y and dp·y·y), NF for w·g_c, and one add per pair for each
# of the 6 + NF per-entry sums.
_PHI = {nf: 2 * nf - 1 for nf in (3, 5)}
_PREFIX, _DPOWER, _MOMENTS = 4, 7, 5
OPS_PER_PAIR_BWD = {nf: RECOMPUTE_PER_PAIR + _PHI[nf] + 3 + _PREFIX
                    + _DPOWER + _MOMENTS + nf + 6 + nf
                    for nf in (3, 5)}                         # 67, 75
# composite_bwd_bf16.cu adds to the recompute, on the fp32 units, 2·NF−1
# for φ and NF bf16 roundings of its operands, 3 for T_i, T_i·φ and w·φ, 1
# rounding of w·φ, ~4 for its prefix, 7 for dα and dpower (as the exact
# backward's), 4 for dx and dy, 2 for dp·dx and dp·dy, 4 roundings when
# staging; on the tensor cores 4 matrices × 8 columns × 2 flops.
OPS_PER_PAIR_BWD_BF16 = {nf: RECOMPUTE_PER_PAIR + _PHI[nf] + nf + 3 + 1
                         + 4 + 7 + 4 + 2 + 4 for nf in (3, 5)}  # 64, 70
MMA_FLOPS_PER_PAIR = 4 * 8 * 2

# fwd_ablate.cu. The tile variants and no_states run composite_sub_staged:
# the forward's 41. The pairs variants' α (absolute means, no tile
# origin): 2 offsets, 9 for the power, expf, o·g, 3 for the mask, the
# clamp: 20; horner's power from its coefficients takes 10 where the
# offsets and the power take 11: 19. The prefix product and w: 1 − α, ~4
# for the product, the compare and 2 multiplies (α·T_excl·[T ≥ 1e-4]): 8;
# the colour sums 10; a max 1.
_PAIR_ALPHA, _HORNER_ALPHA, _SCAN, _ACC = 20, 19, 8, 10
FWD_OPS = {
    "full": OPS_PER_PAIR, "dump_last": OPS_PER_PAIR,
    "no_dump": OPS_PER_PAIR, "small_out": OPS_PER_PAIR,
    "no_states": OPS_PER_PAIR,
    "pairs_only": _PAIR_ALPHA + _SCAN + _ACC,                 # 38
    "pairs_noaccs": _PAIR_ALPHA + _SCAN + 1,                  # 29
    "pairs_noscan": _PAIR_ALPHA + _ACC,                       # 30
    "pairs_alpha": _PAIR_ALPHA + 1,                           # 21
    "horner": _HORNER_ALPHA + _SCAN + _ACC,                   # 37
}


def bwd_ops(variant: str = "full", moments: str = "dot_bf16") -> int:
    """fp32 operations per pair of a bwd_ablate.cu variant (image-only, 3
    colour terms) in a moment form. Its pair step is kernel 4's: the
    geometry variants take kernel 4's 67 (vpu and dot_f32 form the five
    moment terms with 5 multiplies: dp·x, dp·y and three more, or dp times
    the per-pixel monomials), dot_bf16 one rounding of dpower more;
    no_prefix drops the prefix and the add of P; no_geom sums dpower and the
    three w·g_c; recompute_only sums w alone."""
    base = RECOMPUTE_PER_PAIR + _PHI[3] + 3 + _PREFIX + _DPOWER     # 50
    full = base + _MOMENTS + 3 + 6 + 3 + (moments == "dot_bf16")
    return {"full": full, "geom_nostore": full, "geom_concat": full,
            "no_prefix": full - _PREFIX - 1, "no_geom": base + 3 + 4,
            "recompute_only": RECOMPUTE_PER_PAIR + 1}[variant]


# The work each ablation function needs, by name (stream_work): the pairs
# before each strip is done ("open": the tile variants and the backward
# variants that advance the state), those of the subs in their run's first
# block ("first_block": the variants that read the zero state after it),
# or every pair of the computed blocks ("all": the pairs variants).
FWD_NEEDS = {"full": "open", "dump_last": "open", "no_dump": "open",
             "small_out": "open", "no_states": "first_block",
             "pairs_only": "all", "pairs_noaccs": "all",
             "pairs_noscan": "all", "pairs_alpha": "all", "horner": "all"}
BWD_NEEDS = {"full": "open", "no_prefix": "open",
             "geom_nostore": "first_block", "geom_concat": "first_block",
             "no_geom": "first_block", "recompute_only": "first_block"}
STRIP = 32                        # pixels of a strip, entries of a sub
SUB_BYTES = STRIP * 12 * 4        # a sub's payload rows
SLOT_BYTES = 8 * 256 * 4          # a state slot


def _open_strips(done):
    """(…, 8) True where a 32-pixel strip of (…, 256) done flags has a
    pixel that is not done."""
    return done.reshape(done.shape[:-1] + (-1, STRIP)).amin(-1) == 0


def stream_work(sub_tile, sub_valid, states, tiles_x: int, width: int,
                height: int) -> dict:
    """The work each need of an ablation function takes on a stream, from
    the forward's `full` state slots (fwd_ablate_plain(..., "full")):
    {need: (warp-subs, subs)}, warp-subs the (strip, sub) pairs a kernel
    computes (× 32 × 32 (entry, pixel) pairs) and subs those it reads
    (a sub with an open strip)."""
    from msgs_torch.kernels import ablate
    nb = int((sub_valid[::ablate.NSUB] == 1).sum())
    S = nb * ablate.NSUB
    s = sub_tile[:S].long()
    j = torch.arange(S, device=s.device)
    head = torch.ones(S, dtype=torch.bool, device=s.device)
    head[1:] = s[1:] != s[:-1]
    # Done at the start of each sub: the state the sub before left in the
    # same run, or the tile's off-image pixels at a run's head.
    before = ablate._outside(s, tiles_x, width, height)
    before[1:] = torch.where(head[1:, None], before[1:],
                             states[:S - 1, 6])
    open_ = _open_strips(before)                        # (S, 8)
    start = torch.cummax(torch.where(head, j, 0), 0).values
    first = j // ablate.NSUB == start // ablate.NSUB
    n_open = open_.sum(-1)
    return {"open": (int(n_open.sum()), int(open_.any(-1).sum())),
            "first_block": (int(n_open[first].sum()),
                            int(open_[first].any(-1).sum())),
            "all": (8 * S, S)}


def pairs_and_bytes(work, out_bytes: int, sub_tile) -> tuple:
    """(pairs, bytes) of (warp-subs, subs) of stream_work: the subs'
    payload read once, out_bytes written, the stream's ids read once."""
    warp_subs, subs = work
    return (warp_subs * STRIP * STRIP,
            subs * SUB_BYTES + out_bytes + 8 * sub_tile.numel())


def bound(ops_per_pair, pairs, nbytes) -> dict:
    """The least time for `pairs` pairs at ops_per_pair fp32 operations
    and nbytes bytes, and what bounds it."""
    t = {"bytes": nbytes / PEAK_BYTES * 1e3,
         "operations": pairs * ops_per_pair / PEAK_FP32 * 1e3}
    by = max(t, key=t.get)
    return {"bound_ms": t[by], "bound_by": by, "pairs": pairs,
            "operations": pairs * ops_per_pair, "bytes": nbytes}


def saturation_work(stream, width, height) -> tuple:
    """(sub-blocks before each tile saturates, warp-sub-blocks before each
    32-pixel strip of a tile is done) on a main-path stream (payload,
    first_sub, n_sub, tiles, tiles_x), from one pass of the plain
    forward's T and done. The (entry, pixel) pairs kernels 3, 4 and 4b need
    are the strip count × 32 × 32."""
    from msgs_torch.kernels import composite as comp
    payload, first, n_sub, tiles, tx = stream
    dev = payload.device
    feats = payload.reshape(-1, comp.SUB, comp.NFEAT)
    state = comp._init_state(tiles, tx, width, height, dev)
    t_run = state[:, comp.O_T].clone()
    done_run = state[:, comp.O_DONE].clone()
    ox, oy = comp._tile_origin(tiles, tx, dev)
    n_tile = torch.zeros((), dtype=torch.long, device=dev)
    n_strip = torch.zeros((), dtype=torch.long, device=dev)
    for d, tid in enumerate(comp._active_tiles(n_sub, tiles)):
        open_ = _open_strips(done_run[tid])
        n_tile = n_tile + open_.any(-1).sum()
        n_strip = n_strip + open_.sum()
        t_in = t_run[tid][:, None, :]
        done = done_run[tid][:, None, :]
        sub = comp._sub_forward(feats[first[tid].long() + d], ox[tid],
                                oy[tid], t_in, done)
        t_run[tid], done_run[tid] = comp._advance(sub, t_in, done)
    return int(n_tile), int(n_strip)


# The pair-math probe, csrc/mxu_probe.cu (kernel 5), per (entry, pixel)
# pair, counted from that source as above and further: exp2f 2, log1pf 8,
# a division 4, a negation 1; a term the kernel makes once for the two
# pixels of a thread (they share x) counts one half.
#   power 9: dx, cxx·dx, ·dx and cxy·dx once for two pixels (2), dy,
#     cyy·dy, ·dy, the sum, ·(−0.5), ·dy and the subtraction (7); pow_mxu
#     at HIGHEST 9.5 (6 products and 5 adds, the x², x and 1 terms' products
#     shared), at HIGH none (the tensor cores).
#   α 10: expf, o·g, 2 compares and their and, the min, the select; exp2 9
#     (a multiply and exp2f).
#   static T 9: 1 − α, ~4 for the 5-round product (129 products per 32
#     rows), w = (α·T_excl)·[T ≥ 1e-4]: 2 multiplies, a compare, a select.
#   log T at HIGHEST 23: −α and log1pf 9, the running add, expf, 1 − α, the
#     max, the division, compare, select, 2 multiplies; at HIGH 22 and the
#     split of log1p(−α) into two TF32 parts, 3.
#   the 5-row accumulation 10; acc_tn and dfeat_nt at HIGHEST 16 (8
#     products summed: acc_tn's 8 feature rows in all four segments,
#     dfeat_nt's 8 df columns), at HIGH the split of w, 3.
# Tensor-core FLOPs per pair at HIGH, products that are issued: pow_mxu 2
# (the basis is exact in TF32, so its small part's product is left out) ×
# 2 × 6 nonzero monomials; scan_mxu 2 (the triangle is exact) × 2 × 24 (a
# 32-row segment's 16×16 zero block is left out: K = 16 for rows 0-15, 32
# for 16-31); acc_tn and dfeat_nt 3 × 2 × 8. (df[:8] @ basis) adds 1/16 of
# a FLOP a pair and is left out.
_P_POWER, _P_POWER_HORNER, _P_ALPHA, _P_T, _P_ACC = 9, 9.5, 10, 9, 10
PROBE_OPS = {
    ("empty", None): 0,
    ("base", None): _P_POWER + _P_ALPHA + _P_T + _P_ACC,             # 38
    ("exp2", None): _P_POWER + _P_ALPHA - 1 + _P_T + _P_ACC,         # 37
    ("pow_mxu", "HIGHEST"): _P_POWER_HORNER + _P_ALPHA + _P_T + _P_ACC,
    ("pow_mxu", "HIGH"): _P_ALPHA + _P_T + _P_ACC,                   # 29
    ("scan_mxu", "HIGHEST"): _P_POWER + _P_ALPHA + 23 + _P_ACC,      # 52
    ("scan_mxu", "HIGH"): _P_POWER + _P_ALPHA + 22 + 3 + _P_ACC,     # 54
    ("acc_tn", "HIGHEST"): _P_POWER + _P_ALPHA + _P_T + 16,          # 44
    ("acc_tn", "HIGH"): _P_POWER + _P_ALPHA + _P_T + 3,              # 31
    ("dfeat_nt", "HIGHEST"): _P_POWER + _P_ALPHA + _P_T + 16,        # 44
    ("dfeat_nt", "HIGH"): _P_POWER + _P_ALPHA + _P_T + 3,            # 31
}
PROBE_TC_FLOPS = {"pow_mxu": 2 * 2 * 6, "scan_mxu": 2 * 2 * 24,
                  "acc_tn": 3 * 2 * 8, "dfeat_nt": 3 * 2 * 8}
# Pairs one thread covers in a pass of the probe's segment loop (32 rows ×
# its 2 pixels): a kernel's static SASS instructions over this are its
# instructions per pair (the once-a-block and once-a-CTA code included).
PROBE_PAIRS_PER_PASS = 32 * 2


def probe_bound(variant: str, precision, n_blocks: int) -> dict:
    """Least time of a probe run on the H100: its bytes (payload read once,
    the (8, 256) output written once, dfeat_nt's g_rows read once), its
    fp32 operations on the CUDA cores and, at HIGH, its tensor-core FLOPs,
    each at the card's peak; the largest of the three. tc_ms is the
    tensor-core work alone."""
    from msgs_torch.kernels.mxu_probe import BLOCK, NDF, NFEAT, NOUT, NPIX
    pairs = n_blocks * BLOCK * NPIX
    nbytes = n_blocks * BLOCK * NFEAT * 4 + NOUT * NPIX * 4
    if variant == "dfeat_nt":
        nbytes += NDF * NPIX * 4
    times = {"bytes": nbytes / PEAK_BYTES * 1e3,
             "operations": pairs * PROBE_OPS[variant, precision]
             / PEAK_FP32 * 1e3,
             "tensor cores": (pairs * PROBE_TC_FLOPS[variant] / PEAK_TF32
                              * 1e3 if precision == "HIGH" else 0.0)}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by,
            "tc_ms": times["tensor cores"], "pairs": pairs}
