"""The compositor family's work table (msgs_torch/tools/work.py) on the
CPU: the strip counts behind the ablation kernels' bounds against a count
made a sub at a time, one table of operations per pair for chip_smoke.py
and the ablation tools, and the staggered check stream of the card tests
(tests/test_torch_cuda.py) and chip_smoke.py.
"""
import pytest
import torch

import chip_smoke
from msgs_torch.kernels import ablate
from msgs_torch.kernels import composite as comp
from msgs_torch.tools import exp_bwd2
from msgs_torch.tools import exp_fwd_ablate as fa
from msgs_torch.tools import work
from tests.torch_parity import one_torch_thread

TX = (fa.W + 15) // 16
STREAMS = {"clustered": lambda: fa.clustered_stream("cpu", 16),
           "staggered": lambda: fa.staggered_stream("cpu")}


@pytest.fixture(scope="module", params=list(STREAMS))
def stream(request):
    """(payload, sub_tile, sub_valid, tile_last_sub) and the plain forward's
    `full` state slots."""
    with one_torch_thread():
        s = STREAMS[request.param]()
        states = ablate.fwd_ablate_plain(*s[:3], "full", TX, fa.W, fa.H)[0]
    return s, states


def _brute_force(st, sv, states):
    """{need: [warp-subs, subs]} a sub at a time: a strip is open at sub j
    when a pixel of it is not done in the state sub j − 1 left in the same
    run, or off the image at a run's head."""
    nb = int((sv[::4] == 1).sum())
    out = {"open": [0, 0], "first_block": [0, 0], "all": [0, 0]}
    st = st.tolist()
    for j in range(4 * nb):
        if j == 0 or st[j] != st[j - 1]:
            start = j
            t = st[j]
            before = [float((t % TX) * 16 + p % 16 >= fa.W
                            or (t // TX) * 16 + p // 16 >= fa.H)
                      for p in range(256)]
        else:
            before = states[j - 1, comp.O_DONE].tolist()
        n_open = sum(any(d == 0.0 for d in before[32 * u:32 * u + 32])
                     for u in range(8))
        needs = ["open", "all"] + (["first_block"]
                                   if j // 4 == start // 4 else [])
        for need in needs:
            out[need][0] += 8 if need == "all" else n_open
            out[need][1] += 1 if need == "all" else int(n_open > 0)
    return {k: tuple(v) for k, v in out.items()}


def test_stream_work_matches_brute_force(stream):
    """The strip-done counts the bounds use equal a count made from the
    plain forward's per-sub done rows, a sub at a time."""
    (payload, st, sv, _), states = stream
    got = work.stream_work(st, sv, states, TX, fa.W, fa.H)
    assert got == _brute_force(st, sv, states)
    assert 0 < got["first_block"][0] < got["open"][0] < got["all"][0]


def test_main_path_count_matches_stream_count():
    """On the staggered stream, whose tiles' runs hold only valid subs,
    kernel 3's strip count (saturation_work over tile_sub_ranges) equals
    the ablation kernels' count of open strips and subs."""
    payload, st, sv, tls = fa.staggered_stream("cpu")
    tiles = ablate.n_tiles(TX, fa.H)
    first, n_sub = comp.tile_sub_ranges(st, sv, tls, tiles)
    n_tile, n_strip = work.saturation_work(
        (payload, first, n_sub, tiles, TX), fa.W, fa.H)
    states = ablate.fwd_ablate_plain(payload, st, sv, "full", TX, fa.W,
                                     fa.H)[0]
    assert work.stream_work(st, sv, states, TX, fa.W, fa.H)["open"] == (
        n_strip, n_tile)


def test_chip_smoke_and_tools_read_one_table():
    """chip_smoke.py's bounds and the ablation tools' come from one table:
    the same objects, and no tool keeps a count of its own."""
    for name in ("PEAK_BYTES", "PEAK_FP32", "PEAK_BF16", "OPS_PER_PAIR",
                 "OPS_PER_PAIR_BWD", "OPS_PER_PAIR_BWD_BF16",
                 "MMA_FLOPS_PER_PAIR", "saturation_work"):
        assert getattr(chip_smoke, name) is getattr(work, name), name
    for mod in (fa, exp_bwd2):
        for name in ("OPS_PER_PAIR", "OPS_HORNER", "PEAK_FP32",
                     "PEAK_BYTES", "bwd_ops", "bound", "work_subs"):
            assert not hasattr(mod, name), (mod.__name__, name)
    assert fa.work is work and exp_bwd2.work is work


def test_ops_table_covers_every_variant_and_form():
    """Every forward variant and every built backward instance has a
    count and a need; the backward's vpu form is kernel 4's image-only
    count (the same pair step), the forward tile variants kernel 3's."""
    assert set(work.FWD_OPS) == set(work.FWD_NEEDS) == set(ablate.ALL_FWD)
    assert set(work.BWD_NEEDS) == set(ablate.BWD_VARIANTS)
    assert {v for v, _ in ablate.BWD_INSTANCES} == set(ablate.BWD_VARIANTS)
    for v in ablate.TILE_VARIANTS:
        assert work.FWD_OPS[v] == work.OPS_PER_PAIR == 41
    assert work.bwd_ops("full", "vpu") == work.OPS_PER_PAIR_BWD[3] == 67
    assert work.bwd_ops("full", "dot_f32") == 67
    assert work.bwd_ops("full") == 68      # dpower rounded to bf16
    counts = {v: work.bwd_ops(v) for v in ablate.BWD_VARIANTS}
    assert counts == {"full": 68, "geom_nostore": 68, "geom_concat": 68,
                      "no_prefix": 63, "no_geom": 57, "recompute_only": 32}
    for v in ablate.BWD_VARIANTS:
        want = "open" if v in ablate.ADVANCING else "first_block"
        assert work.BWD_NEEDS[v] == want, v


def test_bound_takes_the_larger_time():
    b = work.bound(41, 10**9, 10**6)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(41e9 / work.PEAK_FP32 * 1e3)
    b = work.bound(1, 10, 10**9)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(1e9 / work.PEAK_BYTES * 1e3)


def test_staggered_stream_finishes_strips_where_designed():
    """Strip u of tile 0 is done after sub DONE_AT[u] and not before (four
    strips on each side of the boundary between blocks 0 and 1); the tile
    saturates in sub 6, so blocks 2 and 3 are skipped and dump_last writes
    their 8 slots; the runs of tiles 1 and 2 cross blocks; block 7 does
    not compute."""
    payload, st, sv, tls = fa.staggered_stream("cpu")
    states, written = ablate.fwd_ablate_plain(payload, st, sv, "full", TX,
                                              fa.W, fa.H)
    assert int(written.sum()) == 28
    strip_done = states[:16, comp.O_DONE].reshape(16, 8, 32).amin(-1)
    for u, k in enumerate(fa.DONE_AT):
        assert bool((strip_done[k:, u] == 1).all()), u
        assert bool((strip_done[:k, u] == 0).all()), u
    assert min(fa.DONE_AT) < 4 <= max(fa.DONE_AT)
    skip = ablate.skipped_blocks(st, sv, states)
    assert skip.tolist() == [False, False, True, True, False, False, False]
    _, w_last = ablate.fwd_ablate_plain(payload, st, sv, "dump_last", TX,
                                        fa.W, fa.H)
    assert w_last.nonzero()[:, 0].tolist() == [0, 4, *range(8, 16), 16, 20,
                                               24]
    assert tls[:3].tolist() == [15, 21, 27]
    assert sv.tolist() == [1] * 28 + [0] * 4
    # The rows every faint splat touches: the tiles' pixels are all lit.
    assert bool((states[27, comp.O_R] > 0).all())


def test_sass_histograms_parse_cuobjdump_text():
    """msgs_torch.tools.sass counts each kernel's opcodes, predicated ones
    included, from cuobjdump -sass text."""
    from msgs_torch.tools import sass
    text = """
        Function : _Z3fooPf
        /*0000*/          LDC R1, c[0x0][0x28] ;      /* 0x0000 */
        /*0010*/     @!PT LDS RZ, [RZ] ;              /* 0x0000 */
        /*0020*/          FMUL R2, R2, R3 ;           /* 0x0000 */
        /*0030*/      @P0 FMUL R2, R2, R2 ;           /* 0x0000 */
        /*0040*/          LDS.128 R4, [R0+0x10] ;     /* 0x0000 */
        Function : _Z3barv
        /*0000*/          EXIT ;                      /* 0x0000 */
    """
    h = sass.histograms(text)
    assert h == {"_Z3fooPf": {"LDC": 1, "LDS": 1, "FMUL": 2, "LDS.128": 1},
                 "_Z3barv": {"EXIT": 1}}
    assert sass.kernels(text)["_Z3fooPf"][1:4] == [
        "@!PT LDS RZ, [RZ] ;", "FMUL R2, R2, R3 ;", "@P0 FMUL R2, R2, R2 ;"]
    # Two checkouts of one source name a kernel with other hashes.
    names = ("_ZN46_GLOBAL__N__4511a8e7_13_fwd_ablate_cu_93ccd11915fooEv",
             "_ZN46_GLOBAL__N__0badcafe_13_fwd_ablate_cu_1234567815fooEv")
    assert len({sass._CHECKOUT.sub("", n) for n in names}) == 1
