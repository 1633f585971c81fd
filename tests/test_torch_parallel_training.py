"""The compressed all-reduce, GPipe stages and the elastic restore, against the reference.

- ``compressed_allreduce`` (replicated in, replicated out) equals the
  reference's, run in-process on ``jax.make_mesh((4,), ("pod",))`` over
  the 4 CPU devices that tests/conftest.py forces: the gradients and the
  first position's residual within 1e-6, from a zero and from a nonzero
  residual.  (One call each: the reference's returned residual keeps each
  device's own value behind its first position's, so a second call would
  start the positions from different residuals.)
- ``compressed_allreduce_positions`` (different gradients per position)
  equals the reference's per-leaf body run under ``shard_map`` with
  ``P("pod")`` inputs, position by position, within 1e-6.
- ``pipeline_forward`` on a 4-stage mesh equals the reference's on a
  4-stage jax mesh and the sequential forward within 1e-5 (the case of
  tests/test_distributed.py), and ``split_stages`` the reference's.
- ``restore(..., shardings=)`` equals restoring and then placing with
  ``shard_params``, piece by piece.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.training import grad_compress as RGC  # noqa: E402
from repro.training import pipeline as RPIPE  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import from_reference  # noqa: E402
from repro_torch.core.compressed import ShardedTensor  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training import grad_compress as GC  # noqa: E402
from repro_torch.training import pipeline as PIPE  # noqa: E402
from repro_torch.tree import flatten_with_path  # noqa: E402

TOL = 1e-6


def _grads(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((*lead, 8, 6)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((*lead, 13)).astype(np.float32),
            "blocks": [{"wq": rng.standard_normal((*lead, 2, 5, 7)).astype(np.float32)}]}


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, tol=TOL):
    for (path, a), b in zip(flatten_with_path(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol, rtol=0, err_msg=str(path))


def test_compressed_allreduce_equals_reference(quad_devices):
    jmesh = jax.make_mesh((4,), ("pod",), devices=quad_devices)
    mesh = make_mesh((4,), ("pod",), device="cpu")
    g = _grads(0)
    for r0 in (jax.tree.map(np.zeros_like, g), jax.tree.map(lambda a: a * 0.01, _grads(1))):
        rout, rres = RGC.compressed_allreduce(jax.tree.map(jnp.asarray, g),
                                              jax.tree.map(jnp.asarray, r0), axis="pod",
                                              mesh=jmesh)
        out, res = GC.compressed_allreduce(_t(g), _t(r0), axis="pod", mesh=mesh)
        _close(out, jax.tree.map(np.asarray, rout))
        _close(res, jax.tree.map(np.asarray, rres))
    assert all(torch.equal(t, torch.zeros_like(t)) for _, t in
               flatten_with_path(GC.init_residual(_t(g))))
    # one position: nothing to reduce
    one = make_mesh((1,), ("pod",), device="cpu")
    same, _ = GC.compressed_allreduce(_t(g), res, axis="pod", mesh=one)
    _close(same, g, 0)


def test_per_position_form_equals_reference_shard_map(quad_devices):
    from jax.experimental.shard_map import shard_map
    jmesh = jax.make_mesh((4,), ("pod",), devices=quad_devices)
    stacked = _grads(3, lead=(4,))
    rstack = _grads(4, lead=(4,))

    def body(g, r):
        out, res = RGC._compressed_allreduce_leaf(g[0], r[0], "pod", 4)
        return out[None], res[None]

    fn = shard_map(body, mesh=jmesh, in_specs=(JP("pod"), JP("pod")),
                   out_specs=(JP("pod"), JP("pod")), check_rep=False)
    want = jax.tree.map(lambda g, r: tuple(np.asarray(a) for a in fn(jnp.asarray(g),
                                                                      jnp.asarray(r))),
                        stacked, rstack)
    per = [jax.tree.map(lambda a, i=i: a[i], stacked) for i in range(4)]
    rper = [jax.tree.map(lambda a, i=i: a[i], rstack) for i in range(4)]
    outs, res = GC.compressed_allreduce_positions([_t(p) for p in per], [_t(r) for r in rper])
    for i in range(4):
        _close(outs[i], jax.tree.map(lambda t: t[0][i], want, is_leaf=lambda x: isinstance(x, tuple)))
        _close(res[i], jax.tree.map(lambda t: t[1][i], want, is_leaf=lambda x: isinstance(x, tuple)))
    # the positions' results agree: one all-reduce
    for i in range(1, 4):
        _close(outs[i], jax.tree.map(lambda t: t[0][0], want,
                                     is_leaf=lambda x: isinstance(x, tuple)))


def test_pipeline_forward_equals_reference_and_sequential(quad_devices):
    L, d = 8, 16
    ks = jax.random.split(jax.random.PRNGKey(0), L)
    layers = {"w": jnp.stack([jax.random.normal(k, (d, d)) * 0.2 for k in ks])}
    x = jax.random.normal(jax.random.PRNGKey(1), (6, 3, d))

    def rstage(p, xm):
        def body(xc, w):
            return jnp.tanh(xc @ w), None
        return jax.lax.scan(body, xm, p["w"])[0]

    rstages = RPIPE.split_stages(layers, 4)
    want = RPIPE.pipeline_forward(rstage, rstages, x,
                                  mesh=jax.make_mesh((4,), ("stage",), devices=quad_devices))

    def stage(p, xm):
        for w in p["w"]:
            xm = torch.tanh(xm @ w)
        return xm

    stages = PIPE.split_stages(_t(layers), 4)
    assert stages["w"].shape == tuple(rstages["w"].shape) == (4, 2, d, d)
    np.testing.assert_array_equal(stages["w"].numpy(), np.asarray(rstages["w"]))
    got = PIPE.pipeline_forward(stage, stages, torch.from_numpy(np.array(x)),
                                mesh=make_mesh((4,), ("stage",), device="cpu"))
    seq = torch.stack([stage(_t(layers), torch.from_numpy(np.array(x[m]))) for m in range(6)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(AssertionError):
        PIPE.split_stages(_t(layers), 3)


def _pieces(leaf):
    if isinstance(leaf, ShardedTensor):
        return [t for p in leaf.pieces for t in _pieces(p)]
    return [leaf]


def test_restore_with_shardings_equals_restore_then_shard(tiny_dense, tmp_path):
    rcfg, rparams = tiny_dense
    cfg = from_reference(rcfg)
    params = bridge.from_reference(rparams, device="cpu")
    ckpt.save(str(tmp_path), 3, params)
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        got, step, _ = ckpt.restore(str(tmp_path), params, device="cpu",
                                    shardings=SH.param_shardings(cfg, params, mesh))
        plain, _, _ = ckpt.restore(str(tmp_path), params, device="cpu")
        want = SH.shard_params(plain, cfg, mesh)
        assert step == 3
        flat_got, flat_want = flatten_with_path(got), flatten_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
        assert any(isinstance(t, ShardedTensor) for _, t in flat_got)
        for (path, a), (_, b) in zip(flat_got, flat_want):
            assert type(a) is type(b), path
            for x, y in zip(_pieces(a), _pieces(b)):
                assert torch.equal(x, y), path
