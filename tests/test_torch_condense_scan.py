"""Device condensation of the port (ops/condense_scan.py) on the CPU:
tests/test_condense_scan.py's five cases, each on the same numpy inputs
in the reference and the port, and against the host fp64 build.

Tolerances are the reference's own (rtol 1e-4, atol 1e-5 against the
fp64 operators and ``lsim``; rtol 1e-5 between a batched and a single
build); the two packages' fp32 results agree within the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyhybridcontrol_tpu.models.double_integrator import (
    switched_double_integrator as j_di,
)
from pyhybridcontrol_tpu.ops import condense_scan as jcs
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.models.double_integrator import (
    default_weights,
    switched_double_integrator,
)
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.ops.condense_scan import (
    affine_scan_rollout,
    condense_device,
    condense_horizon_sharded,
    matrix_power_scan,
)
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict

NAMES = ("Phi", "Gv", "Gw", "Gc", "Phi_t", "Gv_t", "Gw_t", "Gc_t")


def test_matrix_power_scan(rng):
    A = (rng.normal(size=(3, 3)) * 0.5).astype(np.float32)
    for N in (1, 6, 13):
        pw = matrix_power_scan(torch.as_tensor(A), N).numpy()
        assert pw.shape == (N + 1, 3, 3)
        want = np.eye(3)
        for k in range(N + 1):
            np.testing.assert_allclose(pw[k], want, rtol=1e-4, atol=1e-5)
            want = want @ A.astype(np.float64)
        np.testing.assert_allclose(
            pw, np.asarray(jcs.matrix_power_scan(jnp.asarray(A), N)),
            rtol=1e-5, atol=1e-6)


def test_affine_scan_matches_lsim(rng):
    model = switched_double_integrator()
    N = 12
    x0 = np.array([1.5, -0.3], np.float32)
    v = rng.uniform(-1, 1, size=(N, model.info.nv)).astype(np.float32)
    xs = affine_scan_rollout(model, torch.as_tensor(x0), torch.as_tensor(v))
    xs_seq, _ = model.lsim(torch.as_tensor(x0), torch.as_tensor(v))
    np.testing.assert_allclose(xs.numpy(), xs_seq[1:].numpy(), rtol=1e-4,
                               atol=1e-5)
    ref = jcs.affine_scan_rollout(j_di(), jnp.asarray(x0), jnp.asarray(v))
    np.testing.assert_allclose(xs.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    # leading batch dims of x0 and v_seq broadcast
    xb = affine_scan_rollout(model, torch.as_tensor(np.stack([x0, -x0])),
                             torch.as_tensor(np.stack([v, v])))
    np.testing.assert_allclose(xb[0].numpy(), xs.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_condense_device_matches_host():
    model = switched_double_integrator()
    N = 8
    c = CondensedMpc(model, N, default_weights())
    dev = condense_device(model, N)
    ref = jax.jit(lambda: jcs.condense_device(j_di(), N))()
    for name in NAMES:
        assert dev[name].shape == np.shape(c.pred[name]), name
        np.testing.assert_allclose(dev[name].numpy(), c.pred[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(dev[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_condense_device_batched_over_models():
    """A leading batch axis on the model's matrices (the reference vmaps
    over stacked model leaves): each instance as condensed alone."""
    Ts = (0.3, 0.5, 0.7)
    models = [switched_double_integrator(Ts=t) for t in Ts]
    stacked = MldModel(mats=StructDict({
        k: torch.stack([m.mats[k] for m in models])
        for k in models[0].mats}), info=models[0].info)
    out = condense_device(stacked, 6)
    assert out["Gv"].shape == (3, 12, 18)
    jm = [j_di(Ts=t) for t in Ts]
    jout = jax.vmap(lambda m: jcs.condense_device(m, 6))(
        jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jm))
    for i, m in enumerate(models):
        solo = condense_device(m, 6)
        host = CondensedMpc(m, 6, default_weights()).pred
        for name in NAMES:
            np.testing.assert_allclose(out[name][i].numpy(),
                                       solo[name].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
            np.testing.assert_allclose(out[name][i].numpy(), host[name],
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(out[name][i].numpy(),
                                       np.asarray(jout[name][i]),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_condense_horizon_sharded_matches():
    """Two ranks (gloo, tests/torch_parallel_ranks.py) each build the block
    rows of four of the N=8 steps; stacked, they are ``condense_device``'s
    Phi and Gv and the reference's ``condense_horizon_sharded`` over a
    two-device mesh. A mesh without the axis is refused."""
    import types

    import torch_parallel_ranks as R
    from pyhybridcontrol_tpu.parallel import make_mesh as j_mesh
    from pyhybridcontrol_tpu_torch.parallel import spawn

    rows = spawn(R.condense_rows, 2, (8,), "cpu", timeout=120)
    full = condense_device(switched_double_integrator(), 8)
    jphi, jgv = jcs.condense_horizon_sharded(j_di(), 8, j_mesh([("hz", 2)]))
    for k, (name, jref) in enumerate((("Phi", jphi), ("Gv", jgv))):
        got = np.concatenate([r[k] for r in rows])
        assert got.shape == tuple(full[name].shape)
        np.testing.assert_allclose(got, full[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(jref), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="no axis 'hz'"):
        condense_horizon_sharded(switched_double_integrator(), 8,
                                 types.SimpleNamespace(
                                     mesh_dim_names=("pool",)))
