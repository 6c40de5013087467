"""Sharded training in msgs_torch (msgs_torch/dist/) against the JAX
package's msgs/dist/ on the CPU, over gloo.

The model, mesh and seed are tests/test_dist.py's: CAP 512, 128×64,
`default_rng(3)`, a 2×4 mesh. The 8 ranks start once for the module (one
spawn, a FileStore in a temporary directory, one torch thread each) and
run every sharded case (tests/torch_dist_ranks.py); this process computes
the JAX side on its 8 virtual devices (through the reference compositor,
the JAX suite's plain version of its Pallas kernels) and the port's
single-device side, and compares. Budgets are tests/test_dist.py's: the
loss within rtol 1e-5, every gradient within 3e-5·max|g|, flags and counts
exact. The dryrun and a 2×2 trainer under torchrun run on the CPU too.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from msgs.dist import mesh as jmesh
from msgs.dist import shard as jshard
from msgs.kernels.rasterize import RasterSettings as JSettings
from msgs.model.gaussians import GaussianConfig as JConfig
from msgs.model.gaussians import create_from_points
from msgs_torch.dist import shard as tshard
from msgs_torch.dist.mesh import mesh_shape
from msgs_torch.dist.multihost import maybe_initialize, rank_device
from msgs_torch.eval.metrics import photometric_loss
from msgs_torch.kernels.rasterize import RasterSettings as TSettings
from msgs_torch.model.gaussians import GaussianConfig as TConfig
from msgs_torch.model.gaussians import state_from_numpy
from msgs_torch.train import loop as tloop
from msgs_torch.train.optimizer import OptimParams
from tests import torch_dist_ranks as R
from tests.torch_parity import cameras, one_torch_thread

CAP, H, W = R.CAP, R.H, R.W
LAMBDAS = (0.0, 0.2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def grad_close(got, want, what):
    scale = max(np.abs(want).max(), 1e-8)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * scale,
                               err_msg=what)


def state_close(got: dict, want: dict, what):
    """tests/test_dist.py's step budget: floats within 1e-5·max|x|,
    integers and flags exact."""
    for k in want:
        a, b = want[k], got[k]
        if a.dtype.kind == "f":
            scale = max(np.abs(a).max(), 1e-8)
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{what}: {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    n = CAP // 2
    means = np.concatenate([
        rng.uniform(-1.0, 1.0, (n, 2)),
        rng.uniform(2.5, 7.0, (n, 1))], axis=1).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cfg = JConfig(sh_degree=1, reso_lvls=2, capacity=CAP)
    st = create_from_points(cfg, means, colors)
    jcam, tcam = cameras(W, H, 0.9, 0.9 * H / W)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    arrays = {k: np.asarray(v) for k, v in st._asdict().items()}
    return cfg, st, jcam, tcam, gt, arrays


@pytest.fixture(scope="module")
def ranks_started(setup, tmp_path_factory):
    """The 8 ranks, started in a thread of this process so that the JAX
    side computes meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    from msgs_torch.dist.launch import run_ranks
    _, _, jcam, _, gt, arrays = setup
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, R.all_cases, 8,
                          (R.inputs(arrays, jcam, gt),), device="cpu",
                          store_dir=str(tmp_path_factory.mktemp("store")))


@pytest.fixture(scope="module")
def dryrun_started():
    """dryrun_multichip(4) on the CPU, started in a thread of this process
    (it spawns its own 4 ranks) so that it too runs while JAX compiles."""
    from concurrent.futures import ThreadPoolExecutor

    from msgs_torch.dist.dryrun import dryrun_multichip
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(dryrun_multichip, 4, device="cpu")


@pytest.fixture(scope="module")
def ranks(ranks_started):
    """Every rank's results (rank order); rank r is mesh cell divmod(r, 4)."""
    return ranks_started.result()


@pytest.fixture(scope="module")
def mesh_trainer(tmp_path_factory):
    """(directory, scene, process) of a 2×2 --mesh trainer on a tiny
    synthetic scene, started by torchrun as a user would start it; it runs
    while the JAX side compiles (jax_sharded asks for it, and for the
    other processes' fixtures, before it starts)."""
    from msgs_torch.data.synthetic import make_scene
    root = tmp_path_factory.mktemp("trainer")
    scene = str(root / "scene")
    with one_torch_thread():
        make_scene(scene, n_views=6, n_test=2, width=48, height=40,
                   n_gaussians=1500, device="cpu", quiet=True)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(root / "torchrun.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "4", "-m", "msgs_torch.apps.train",
             "--mesh", "2", "2", "--dist_backend", "gloo",
             *_train_argv(scene, str(root / "mesh"))],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    yield root, scene, proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def shard_rows(ranks, pick):
    """A capacity-leading result assembled from the gauss shards (the
    t = 0 rank of each)."""
    return np.concatenate([pick(ranks[g * 4]) for g in range(2)])


@pytest.fixture(scope="module")
def jax_sharded(setup, ranks_started, mesh_trainer, dryrun_started):
    """msgs.dist.shard.build_sharded_loss's value and gradients at each λ."""
    cfg, st, jcam, _, gt, _ = setup
    mesh = jmesh.make_mesh(n_gauss=2, n_tile=4)
    settings = JSettings(backend="reference", entry_cap=R.ENTRY_CAP)
    gauss_sh = NamedSharding(mesh, P(jmesh.GAUSS_AXIS))
    repl = NamedSharding(mesh, P())
    params, side = jshard.state_as_dicts(st)
    params = {k: jax.device_put(v, gauss_sh) for k, v in params.items()}
    side = {k: jax.device_put(v, repl if k == "active_sh_degree"
                              else gauss_sh) for k, v in side.items()}
    probe = jax.device_put(jnp.zeros((CAP, 2)), gauss_sh)
    gt_sh = jax.device_put(jnp.asarray(gt), NamedSharding(
        mesh, P((jmesh.GAUSS_AXIS, jmesh.TILE_AXIS))))
    out = {}
    for lam in LAMBDAS:
        loss_fn = jshard.build_sharded_loss(mesh, cfg, settings, H, W,
                                            lambda_dssim=lam,
                                            packet_cap=CAP // 2)
        (loss, aux), (g, pg) = jax.jit(
            lambda p, s, pr, gt_: jax.value_and_grad(
                loss_fn, argnums=(0, 2), has_aux=True)(
                    p, s, pr, jcam, gt_))(params, side, probe, gt_sh)
        out[lam] = (float(loss), jax.tree_util.tree_map(np.asarray, aux),
                    {k: np.asarray(v) for k, v in g.items()},
                    np.asarray(pg))
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_make_mesh_shape(n):
    want = jmesh.make_mesh(devices=jax.devices()[:n]).shape
    assert mesh_shape(n) == (want[jmesh.GAUSS_AXIS], want[jmesh.TILE_AXIS])


@pytest.mark.parametrize("n_stripes", [1, 2, 4, 8])
def test_padded_height_and_auto_packet_cap(n_stripes):
    for height in (1, 15, 16, 17, 100, 128, 511, 512, 1080):
        assert (tshard.padded_height(height, n_stripes)
                == jshard.padded_height(height, n_stripes)), height
    for n_gauss in (1, 2, 4):
        if n_stripes % n_gauss:
            continue
        for capacity in (256, 512, 4096, 131072, 1 << 20):
            n_tile = n_stripes // n_gauss
            assert (tshard.auto_packet_cap(capacity, n_gauss, n_tile)
                    == jshard.auto_packet_cap(capacity, n_gauss, n_tile))


def test_pad_gt():
    gt = np.random.default_rng(1).uniform(0, 1, (37, 20, 3)).astype(
        np.float32)
    hp = tshard.padded_height(37, 4)
    want = np.asarray(jshard.pad_gt(jnp.asarray(gt), hp))
    got = tshard.pad_gt(torch.tensor(gt), hp).numpy()
    np.testing.assert_array_equal(got, want)


def test_maybe_initialize_disabled_is_main():
    assert maybe_initialize(False) is True


def test_nccl_refuses_the_cpu():
    """NCCL needs a card a rank; nothing switches the backend."""
    from msgs_torch.dist.launch import run_ranks
    with pytest.raises(ValueError, match="NCCL"):
        rank_device("cpu", "nccl")
    with pytest.raises(ValueError, match="NCCL"):
        run_ranks(R.all_cases, 2, (None,), backend="nccl", device="cpu")


@pytest.mark.parametrize("call", ["rank_device", "current_rank_device",
                                  "make_mesh", "run_ranks",
                                  "dryrun_multichip"])
def test_default_device_is_the_card(monkeypatch, call):
    """device=None means the card, as everywhere in the port: without one
    the dist entry points raise before any rank starts."""
    from msgs_torch.dist import dryrun, launch, mesh, multihost
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    calls = {
        "rank_device": lambda: multihost.rank_device(None, "gloo"),
        "current_rank_device": multihost.current_rank_device,
        "make_mesh": mesh.make_mesh,
        "run_ranks": lambda: launch.run_ranks(R.all_cases, 2, (None,)),
        "dryrun_multichip": lambda: dryrun.dryrun_multichip(4)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[call]()


@pytest.mark.parametrize("device, backend, rank, here, want", [
    (None, "nccl", 1, 2, "cuda:1"),       # a card a rank
    ("cuda", "gloo", 3, 4, "cuda:1"),     # modulo the host's cards
    ("cuda:0", "gloo", 3, 4, "cuda:0"),   # gloo ranks share a named card
    ("cuda:1", "nccl", 0, 1, "cuda:1"),
    ("cuda:0", "nccl", 0, 2, None),       # NCCL: two ranks on one card
    ("cuda", "nccl", 0, 3, None),         # NCCL: more ranks than cards
])
def test_rank_device_rule(monkeypatch, device, backend, rank, here, want):
    """multihost.rank_device, the one placement rule (two cards faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if want is None:
        with pytest.raises(ValueError, match="NCCL needs one card per rank"):
            rank_device(device, backend, rank=rank, ranks_here=here)
    else:
        assert rank_device(device, backend, rank=rank,
                           ranks_here=here) == torch.device(want)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_sharded_loss_matches_jax(jax_sharded, ranks, lam):
    jloss, jaux, jg, jpg = jax_sharded[lam]
    key = f"loss_{lam}"
    for r in ranks:   # every rank reports the whole image's numbers
        np.testing.assert_allclose(r[key]["loss"], jloss, rtol=1e-5)
        assert r[key]["num_entries"] == int(jaux.num_entries)
        assert r[key]["overflow"] == int(jaux.overflow) == 0
        assert r[key]["exch_overflow"] == int(jaux.exch_overflow)
    for k in jg:
        grad_close(shard_rows(ranks, lambda r: r[key]["grads"][k]), jg[k], k)
    grad_close(shard_rows(ranks, lambda r: r[key]["probe"]), jpg, "probe")
    np.testing.assert_array_equal(
        shard_rows(ranks, lambda r: r[key]["contributed"]),
        np.asarray(jaux.contributed))
    np.testing.assert_array_equal(
        shard_rows(ranks, lambda r: r[key]["radii"]), np.asarray(jaux.radii))
    assert np.asarray(jaux.contributed).any()


@pytest.mark.parametrize("lam", LAMBDAS)
def test_sharded_loss_matches_port_single_device(setup, ranks, lam):
    _, _, _, tcam, gt, arrays = setup
    st = state_from_numpy(arrays, "cpu")
    cfg = TConfig(sh_degree=1, reso_lvls=2, capacity=CAP)
    params = {k: v.clone().requires_grad_() for k, v in st.params().items()}
    probe = torch.zeros((CAP, 2), requires_grad=True)
    with one_torch_thread():
        out = tloop.render_state(st.with_params(params), tcam, cfg,
                                 TSettings(entry_cap=R.ENTRY_CAP),
                                 bg=torch.zeros(3), means2d_probe=probe)
        loss = photometric_loss(out.image, torch.tensor(gt), lam)
        gs = torch.autograd.grad(loss, list(params.values()) + [probe],
                                 allow_unused=True)
    loss = loss.detach()
    key = f"loss_{lam}"
    for r in ranks:
        np.testing.assert_allclose(r[key]["loss"], float(loss), rtol=1e-5)
    for k, g in zip(params, gs):
        want = np.zeros(params[k].shape, np.float32) if g is None \
            else g.numpy()
        grad_close(shard_rows(ranks, lambda r: r[key]["grads"][k]), want, k)
    grad_close(shard_rows(ranks, lambda r: r[key]["probe"]), gs[-1].numpy(),
               "probe")


def test_packet_cap_growth_converges(ranks):
    """An undersized packet cap reports exch_overflow > 0 and leaves every
    rank's state bit for bit; doubling converges, and the grown step is
    the untruncated one (tests/test_dist.py:89)."""
    for r in ranks:
        g = r["growth"]
        assert g["exch_overflow_big"] == 0 and g["overflow_big"] == 0
        att = g["attempts"]
        assert att[0][1] > 0, "the undersized packet_cap never overflowed"
        assert all(unchanged for _, eo, unchanged in att[:-1]), att
        assert att[-1][1] == 0 and att[-1][0] <= 4 * CAP, att
        assert not att[-1][2], "the converged step left the state as it was"
        np.testing.assert_allclose(g["loss_new"], g["loss_big"], rtol=1e-6)
        state_close(g["new"], g["big"], f"rank {r['coord']}")
    # Every rank saw the same sequence of overflows.
    assert len({tuple(r["growth"]["attempts"]) for r in ranks}) == 1


def test_tile_peers_bit_identical(ranks):
    for g in range(2):
        base = ranks[g * 4]["growth"]
        for t in range(1, 4):
            peer = ranks[g * 4 + t]["growth"]
            for which in ("big", "new"):
                for k, v in base[which].items():
                    np.testing.assert_array_equal(
                        peer[which][k], v, err_msg=f"({g},{t}) {which} {k}")


def test_sharded_step_matches_single_train_step(setup, ranks):
    _, _, _, tcam, gt, arrays = setup
    cfg = TConfig(sh_degree=1, reso_lvls=2, capacity=CAP)
    state = tloop.init_train_state(state_from_numpy(arrays, "cpu"))
    with one_torch_thread():
        new, m = tloop.train_step(
            state, tcam, torch.tensor(gt), cfg=cfg, op=OptimParams(),
            settings=TSettings(entry_cap=R.ENTRY_CAP), reso_lvl=0,
            spatial_lr_scale=1.0)
    want = R._numpy(new)
    got = {k: shard_rows(ranks, lambda r: r["growth"]["big"][k])
           if want[k].ndim else ranks[0]["growth"]["big"][k] for k in want}
    np.testing.assert_allclose(ranks[0]["growth"]["loss_big"],
                               float(m["loss"]), rtol=1e-5)
    assert ranks[0]["growth"]["num_live_big"] == int(m["num_live"])
    state_close(got, want, "sharded vs single-device step")


def test_dryrun_multichip_cpu(dryrun_started):
    recs = dryrun_started.result()
    r = recs[0]
    assert r["mesh"] == {"gauss": 2, "tile": 2}
    assert r["grown"] >= 1 and r["inserted"] > 0
    assert r["densified"][0] != r["densified"][1]
    assert r["overflow"] == r["exch_overflow"] == 0
    assert r["launch_counts"]["composite_fwd"] == 0   # the CPU's plain path


def _train_argv(scene, model):
    return ["-s", scene, "-m", model, "--device", "cpu", "--iterations",
            "10", "--capacity", "1024", "--entry_cap", "4096",
            "--test_interval", "0", "--test_iterations", "-1",
            "--save_iterations", "-1", "--sh_degree", "1",
            "--densify_from_iter", "5", "--densification_interval", "4",
            "--disable_gui", "--no_tensorboard", "--quiet"]


def _log(model):
    return [json.loads(line) for line in
            open(os.path.join(model, "train_log.jsonl"))]


def test_trainer_mesh_matches_single_device(mesh_trainer):
    """A 2×2 --mesh trainer under torchrun on the CPU: 10 iterations with a
    densify at 8; its iteration-10 loss is the single-device trainer's
    within 1e-4 relative."""
    from msgs_torch.apps import train
    root, scene, proc = mesh_trainer
    with one_torch_thread():
        train.main(_train_argv(scene, str(root / "single")))
    rc = proc.wait(timeout=600)
    assert rc == 0, (root / "torchrun.log").read_text()[-6000:]
    single, mesh = _log(str(root / "single")), _log(str(root / "mesh"))
    dens = [r for r in mesh if r.get("event") == "densify"]
    assert [r["it"] for r in dens] == [8]
    assert dens == [r for r in single if r.get("event") == "densify"]
    want = next(r["loss"] for r in single if r.get("it") == 10
                and "loss" in r)
    got = next(r["loss"] for r in mesh if r.get("it") == 10 and "loss" in r)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_trainer_mesh_without_torchrun_raises(tmp_path, monkeypatch):
    from msgs_torch.apps import train
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError,
                       match="torchrun --nproc_per_node 4 -m "
                             "msgs_torch.apps.train --mesh 2 2"):
        train.main(["--mesh", "2", "2", *_train_argv(
            str(tmp_path), str(tmp_path / "m"))])
    with pytest.raises(ValueError, match="--multihost"):
        train.main(["--multihost", *_train_argv(
            str(tmp_path), str(tmp_path / "m"))])


def test_dist_imports_neither_jax_nor_nn_functional():
    import re
    bad = re.compile(r"^\s*(import|from)\s+(jax|msgs|torch\.distributed\.nn)"
                     r"\b", re.M)
    root = os.path.join(REPO, "msgs_torch", "dist")
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            src = open(os.path.join(root, name)).read()
            assert not bad.search(src), f"{name}: {bad.search(src)}"
