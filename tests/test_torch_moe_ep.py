"""PyTorch port, expert parallelism across processes: `parallel.moe_apply`
in two CPU processes (gloo, a `make_mesh(ep=2)` mesh) against the JAX
package's `moe_apply` on a 2-device `ep` mesh, from the same numpy inputs.

This pins the layout of the all_to_all exchange that one card cannot
show: each process takes half of the tokens and half of the experts;
its rows of y and the mean aux loss must equal the JAX rows, and so
must the gradients of sum(y^2): in the x rows and the w1 and w2 experts
of each process, and in the replicated router summed over the processes.

The processes rendezvous through a file under the test's tmp_path (no
ports); each gets a time limit, so a hang fails this test and not the
suite. Tolerances as tests/test_torch_moe.py's: y and aux 1e-5,
gradients 1e-4 relative + 1e-5.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mxnet_tpu import config
from mxnet_tpu.parallel import moe as moe_j

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.ops import nn_ops

rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{where}/rdzv",
                        world_size=world, rank=rank)
d = np.load(f"{where}/in.npz")
act = {"gelu": nn_ops.gelu, "relu": torch.relu}[str(d["act"])]
mesh = parallel.make_mesh(ep=world)
assert mesh.coordinate("ep") == rank
ts = [torch.from_numpy(d[k]).requires_grad_(True)
      for k in ("x", "router", "w1", "w2")]
y, aux = parallel.moe_apply(*ts, capacity_factor=float(d["cf"]),
                            activation=act)
(y ** 2).sum().backward()
np.savez(f"{where}/out{rank}.npz", y=y.detach().numpy(),
         aux=aux.detach().numpy(), gx=ts[0].grad.numpy(),
         grouter=ts[1].grad.numpy(), gw1=ts[2].grad.numpy(),
         gw2=ts[3].grad.numpy())
dist.destroy_process_group()
"""


def _run_workers(where, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD), str(where)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, err in errs:
        assert rc == 0, err[-3000:]
    return [dict(np.load(f"{where}/out{r}.npz")) for r in range(WORLD)]


_ACTS = {"gelu": jax.nn.gelu, "relu": jax.nn.relu}


@pytest.mark.parametrize("act,cf", [("gelu", 1.25), ("relu", 0.5)])
def test_moe_apply_ep2_matches_jax(tmp_path, act, cf):
    rng = np.random.RandomState(7)
    N, D, F, E = 32, 16, 24, 4                   # 2 experts a process
    arrays = {"x": rng.randn(N, D).astype(np.float32),
              "router": rng.randn(D, E).astype(np.float32),
              "w1": (rng.randn(E, D, F) * 0.1).astype(np.float32),
              "w2": (rng.randn(E, F, D) * 0.1).astype(np.float32)}
    np.savez(tmp_path / "in.npz", act=act, cf=cf, **arrays)
    outs = _run_workers(tmp_path)

    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("ep",))

    def loss(x, r, w1, w2):
        y, aux = moe_j.moe_apply(x, r, w1, w2, mesh=mesh, capacity_factor=cf,
                                 activation=_ACTS[act])
        return jnp.sum(y ** 2), (y, aux)

    config.set("kernels", "off")
    try:
        (_, (yj, aj)), gj = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True))(
                *[jnp.asarray(arrays[k]) for k in ("x", "router", "w1",
                                                   "w2")])
    finally:
        config.reset("kernels")
    yj, gx, grouter, gw1, gw2 = (np.asarray(a) for a in (yj, *gj))
    n, e = N // WORLD, E // WORLD
    for r, o in enumerate(outs):
        rows, experts = slice(r * n, (r + 1) * n), slice(r * e, (r + 1) * e)
        assert o["y"].shape == (n, D)
        np.testing.assert_allclose(o["y"], yj[rows], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(o["aux"]), float(aj), rtol=1e-5,
                                   atol=1e-5)
        for name, got, want in (("x", o["gx"][rows], gx[rows]),
                                ("w1", o["gw1"][experts], gw1[experts]),
                                ("w2", o["gw2"][experts], gw2[experts])):
            assert np.abs(want).max() > 0, name
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r} {name}")
        # the slices of the other process get no gradient here
        assert not np.delete(o["gx"], np.arange(r * n, (r + 1) * n), 0).any()
        assert not np.delete(o["gw1"], np.arange(r * e, (r + 1) * e), 0).any()
    np.testing.assert_allclose(sum(o["grouter"] for o in outs), grouter,
                               rtol=1e-4, atol=1e-5)
