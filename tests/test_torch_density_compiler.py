"""The density compiler (``binf_tpu_torch/ops/kernels/density_compiler.py``)
against the JAX package's lane interpreter cases (``tests/test_tile_interpreter.py``),
on the CPU.

Each case of ``test_tile_interpreter.py`` has a torch counterpart of its
density here.  The torch density is traced and lowered to a functor, and the
functor is compiled with ``g++`` through ``csrc/host_compat.h`` (one shared
library for the module).  Its potential U and gradient are held against the
JAX case's own reference, ``jax.value_and_grad`` of the JAX function, at 16
points drawn from a numpy seed: within 1e-4 of the largest |entry| of each
(float32 sums in other orders), unless a case says why not.  The
random-effects case is also held against the JAX package's
``tile_potential_from_scalar(...).tile_value_and_grad``.  Then the refusals:
``linalg.eigvalsh``, a data-dependent branch, the node cap, D =
``MAX_D_WIDE + 1`` (past the wide form's 4,096).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from binf_tpu_torch.ops.kernels import density_compiler as dc
from binf_tpu_torch.ops.kernels.density_compiler import UnsupportedOpError

P = 16  # points a case is evaluated at
RTOL = 1e-4  # of the largest |U| and |grad U|

A_NP = (np.arange(12.0, dtype=np.float32).reshape(4, 3) / 10.0)
Y12 = np.random.default_rng(0).normal(size=12).astype(np.float32)


def _i(x):
    return torch.as_tensor(x, dtype=torch.int64)


# -- the cases: name -> (D, JAX log density of q (D,), torch counterpart) -------------


def _jax_ar(q):
    phi, x0 = q[0] * 0.5, q[1]

    def step(c, _):
        c = phi * c + 0.1
        return c, c

    _, ys = jax.lax.scan(step, x0, None, length=12)
    return jnp.sum(ys ** 2)


def _torch_ar(q):
    phi, c = q[0] * 0.5, q[1]
    ys = []
    for _ in range(12):
        c = phi * c + 0.1
        ys.append(c)
    return torch.sum(torch.stack(ys) ** 2)


def _jax_ar_long(q):
    phi, x0 = q[0] * 0.2, q[1]

    def step(c, t):
        c = phi * c + 0.01 * t
        return c, c * c

    _, ys = jax.lax.scan(step, x0, jnp.arange(200.0))
    return jnp.sum(ys)


def _torch_ar_long(q):
    phi, c = q[0] * 0.2, q[1]
    out = []
    for t in range(200):
        c = phi * c + 0.01 * t
        out.append(c * c)
    return torch.sum(torch.stack(out))


def _jax_scan_xs(q):
    def step(c, x):
        return c + x * x, c

    cf, ys = jax.lax.scan(step, 0.0, q)
    return cf + jnp.sum(ys)


def _torch_scan_xs(q):
    c, ys = torch.zeros(()), []
    for k in range(q.shape[0]):
        ys.append(c)
        c = c + q[k] * q[k]
    return c + torch.sum(torch.stack(ys))


def _jax_switch(q):
    i = jnp.clip(jnp.int32(q[0] + 1), 0, 2)
    return jax.lax.switch(i, [lambda x: jnp.sum(x), lambda x: jnp.sum(x ** 2),
                              lambda x: jnp.max(x)], q)


def _torch_switch(q):
    i = torch.clip((q[0] + 1).to(torch.int32), 0, 2)
    # a 0-d index tensor would be read as a Python int: index with a 1-d one
    return torch.stack([q.sum(), (q ** 2).sum(), q.max()])[i.long().reshape(1)][0]


def _jax_random_effects(pos):
    y = jnp.asarray(Y12)
    assign = jnp.clip((jnp.tanh(pos["boundaries"]) * 2 + 2).astype(jnp.int32), 0, 3)
    effects = pos["effects"]
    resid = y - effects[assign]
    counts = jnp.zeros(4).at[assign].add(jnp.ones(12))
    return (-0.5 * jnp.sum(resid ** 2) - 0.5 * jnp.sum(effects ** 2)
            - 0.01 * jnp.sum(counts ** 2) - 0.5 * jnp.sum(pos["boundaries"] ** 2))


def _torch_random_effects(pos):
    y = torch.tensor(Y12)
    assign = torch.clip((torch.tanh(pos["boundaries"]) * 2 + 2).to(torch.int64), 0, 3)
    effects = pos["effects"]
    resid = y - effects[assign]
    counts = torch.zeros(4).index_put((assign,), torch.ones(12), accumulate=True)
    return (-0.5 * torch.sum(resid ** 2) - 0.5 * torch.sum(effects ** 2)
            - 0.01 * torch.sum(counts ** 2) - 0.5 * torch.sum(pos["boundaries"] ** 2))


CASES = {
    # test_interpreter_basic_ops: transpose, strided slice, a constant
    # matmul, concatenate, reductions
    "basic_ops": (6, lambda q: (lambda m: jnp.sum(jnp.concatenate(
        [m.T[0, ::2], jnp.asarray(A_NP) @ m[:, 0]]) ** 2) + jnp.max(m)
        + jnp.sum(jnp.sin(q[1::3])))(q.reshape(3, 2)),
        lambda q: (lambda m: torch.sum(torch.cat(
            [m.T[0, ::2], torch.tensor(A_NP) @ m[:, 0]]) ** 2) + torch.max(m)
            + torch.sum(torch.sin(q[1::3])))(q.reshape(3, 2))),
    # what the port's DSL and its gradients emit besides: lgamma and
    # digamma of a latent (their gradients digamma and trigamma), erf,
    # erfc, log1p, softplus, sigmoid, logsumexp
    "special_functions": (8, lambda q: jnp.sum(jax.scipy.special.gammaln(jnp.exp(q[:2])))
                          + jnp.sum(jax.scipy.special.digamma(jnp.exp(q[2:4]) + 0.5))
                          + jnp.sum(jax.scipy.special.erf(q[4:6]))
                          + jnp.sum(jax.scipy.special.erfc(q[6:8]))
                          + jnp.sum(jnp.log1p(jnp.exp(q[:3]))) + jnp.sum(jax.nn.softplus(q))
                          + jnp.sum(jax.nn.sigmoid(q))
                          + jax.scipy.special.logsumexp(q),
                          lambda q: torch.sum(torch.lgamma(torch.exp(q[:2])))
                          + torch.sum(torch.digamma(torch.exp(q[2:4]) + 0.5))
                          + torch.sum(torch.erf(q[4:6])) + torch.sum(torch.erfc(q[6:8]))
                          + torch.sum(torch.log1p(torch.exp(q[:3])))
                          + torch.sum(F.softplus(q)) + torch.sum(torch.sigmoid(q))
                          + torch.logsumexp(q, 0)),
    # test_interpreter_extra_rules: pad, rev, per-chain matmul, max, min
    "extra_rules": (6, lambda q: (lambda m: jnp.sum(jnp.pad(q, (1, 1)))
                                  + jnp.sum(q[::-1] * q) + jnp.sum(m @ m.T) + jnp.max(m)
                                  + jnp.min(q))(q.reshape(2, 3)),
                    lambda q: (lambda m: torch.sum(F.pad(q, (1, 1)))
                               + torch.sum(torch.flip(q, [0]) * q) + torch.sum(m @ m.T)
                               + torch.max(m) + torch.min(q))(q.reshape(2, 3))),
    # test_sort_and_argsort, its four densities
    "sort": (7, lambda q: jnp.sum(jnp.sort(q) * jnp.arange(7.0)),
             lambda q: torch.sum(torch.sort(q).values * torch.arange(7.0))),
    "argsort": (7, lambda q: jnp.sum(jnp.argsort(q).astype(jnp.float32) * q),
                lambda q: torch.sum(torch.argsort(q).float() * q)),
    "co_sort": (6, lambda q: jnp.sum(jnp.sort(q) * jnp.arange(1.0, 7.0))
                + jnp.sum(jnp.argsort(q).astype(jnp.float32) * jnp.arange(6.0)),
                lambda q: (lambda s: torch.sum(s.values * torch.arange(1.0, 7.0))
                           + torch.sum(s.indices.float() * torch.arange(6.0)))(torch.sort(q))),
    "top_k": (10, lambda q: jnp.sum(jnp.sort(q)[-3:]),
              lambda q: torch.sum(torch.sort(q).values[-3:])),
    # test_argmax_argmin (no gradient: an integer)
    "argmax_argmin": (9, lambda q: jnp.argmax(q).astype(jnp.float32)
                      + jnp.argmin(q).astype(jnp.float32),
                      lambda q: torch.argmax(q).float() + torch.argmin(q).float()),
    "argmax_axis": (12, lambda q: jnp.sum(jnp.argmax(q.reshape(3, 4), axis=1)
                                          .astype(jnp.float32)),
                    lambda q: torch.sum(torch.argmax(q.reshape(3, 4), dim=1).float())),
    # test_cumulative_ops
    "cumsum": (11, lambda q: jnp.sum(jnp.cumsum(q) * q),
               lambda q: torch.sum(torch.cumsum(q, 0) * q)),
    "cumprod": (6, lambda q: jnp.sum(jnp.cumprod(jnp.abs(q) + 0.5)),
                lambda q: torch.sum(torch.cumprod(torch.abs(q) + 0.5, 0))),
    "cumlogsumexp": (9, lambda q: jnp.sum(jax.lax.cumlogsumexp(q)),
                     lambda q: torch.sum(torch.logcumsumexp(q, 0))),
    "cumsum_axis": (12, lambda q: jnp.sum(jnp.cumsum(q.reshape(3, 4), axis=1) * q.reshape(3, 4)),
                    lambda q: torch.sum(torch.cumsum(q.reshape(3, 4), 1) * q.reshape(3, 4))),
    "cumsum_rev": (5, lambda q: jnp.sum(jnp.cumsum(q[::-1])),
                   lambda q: torch.sum(torch.cumsum(torch.flip(q, [0]), 0))),
    # test_iota_primitive
    "iota": (5, lambda q: jnp.sum(q * jax.lax.iota(jnp.float32, 5)),
             lambda q: torch.sum(q * torch.arange(5, dtype=torch.float32))),
    # test_reduce_middle_axis
    "max_middle": (12, lambda q: jnp.sum(jnp.max(q.reshape(4, 3), axis=1)),
                   lambda q: torch.sum(torch.amax(q.reshape(4, 3), dim=1))),
    "logsumexp_middle": (30, lambda q: jnp.sum(jax.scipy.special.logsumexp(
        q.reshape(5, 2, 3), axis=1)),
        lambda q: torch.sum(torch.logsumexp(q.reshape(5, 2, 3), dim=1))),
    # test_dynamic_slice_per_chain (a gather of a per-chain window)
    "dynamic_slice": (8, lambda q: jnp.sum(jax.lax.dynamic_slice(
        q, (jnp.clip(jnp.int32(q[0] * 2 + 2), 0, 5),), (3,))),
        lambda q: torch.sum(q[torch.clip((q[0] * 2 + 2).to(torch.int64), 0, 5)
                              + torch.arange(3)])),
    "scalar_index": (8, lambda q: q[jnp.clip(jnp.int32(q[1] * 3 + 3), 0, 7)] * 2.0,
                     lambda q: q[torch.clip((q[1] * 3 + 3).to(torch.int64), 0, 7)
                                 .reshape(1)][0] * 2.0),
    # test_dynamic_update_slice_per_chain
    "dynamic_update": (8, lambda q: jnp.sum(jax.lax.dynamic_update_slice(
        q, jnp.ones(2) * 3.0, (jnp.clip(jnp.int32(q[0] + 2), 0, 5),)) * q),
        lambda q: torch.sum(q.index_put(
            (torch.clip((q[0] + 2).to(torch.int64), 0, 5) + torch.arange(2),),
            torch.ones(2) * 3.0) * q)),
    # test_cond_and_switch (torch.where takes the place of cond)
    "cond": (6, lambda q: jax.lax.cond(q[0] > 0, lambda x: jnp.sum(x ** 2),
                                       lambda x: -jnp.sum(x), q),
             lambda q: torch.where(q[0] > 0, torch.sum(q ** 2), -torch.sum(q))),
    "switch": (6, _jax_switch, _torch_switch),
    # test_scan_rules (a Python loop unrolls in the trace)
    "scan_ar": (4, _jax_ar, _torch_ar),
    "scan_ar_long": (4, _jax_ar_long, _torch_ar_long),
    "scan_xs": (10, _jax_scan_xs, _torch_scan_xs),
    # test_gather_per_chain_indices
    "gather": (8, lambda q: jnp.sum(q[jnp.clip((q[:3] * 2 + 4).astype(jnp.int32), 0, 7)]
                                    * jnp.arange(3.0)),
               lambda q: torch.sum(q[torch.clip((q[:3] * 2 + 4).to(torch.int64), 0, 7)]
                                   * torch.arange(3.0))),
    # test_scatter_add_segment_sum
    "segment_sum": (6, lambda q: jnp.sum(jnp.zeros(3).at[jnp.array([0, 1, 0, 2, 1, 0])]
                                         .add(q) ** 2),
                    lambda q: torch.sum(torch.zeros(3).index_add(
                        0, _i([0, 1, 0, 2, 1, 0]), q) ** 2)),
    # test_scatter_add_per_chain_indices
    "scatter_add": (8, lambda q: jnp.sum(jnp.zeros(4).at[
        jnp.clip((q[:4] * 2 + 2).astype(jnp.int32), 0, 3)].add(q[4:]) ** 2
        * jnp.arange(1.0, 5.0)),
        lambda q: torch.sum(torch.zeros(4).index_put(
            (torch.clip((q[:4] * 2 + 2).to(torch.int64), 0, 3),), q[4:], accumulate=True) ** 2
            * torch.arange(1.0, 5.0))),
    # test_scatter_set_per_chain_indices
    "scatter_set": (4, lambda q: jnp.sum(jnp.full((6,), -1.0).at[jnp.concatenate(
        [jnp.clip((q[:1] * 2 + 1).astype(jnp.int32), 0, 2),
         jnp.clip((q[1:2] * 2 + 4).astype(jnp.int32), 3, 5)])].set(q[2:4]) * jnp.arange(6.0)),
        lambda q: torch.sum(torch.full((6,), -1.0).index_put((torch.cat(
            [torch.clip((q[:1] * 2 + 1).to(torch.int64), 0, 2),
             torch.clip((q[1:2] * 2 + 4).to(torch.int64), 3, 5)]),), q[2:4])
            * torch.arange(6.0))),
}


def _models():
    """The model cases (``test_polynomial_model``, ``test_logistic_model``,
    ``test_hierarchical_model_matrix_variables``, the mixture, statespace and
    random-effects densities): name -> (JAX log density, torch log
    density, template shapes), both from the JAX package's synthetic data."""
    from binf_tpu.example import hierarchical as jh
    from binf_tpu.example import logistic as jl
    from binf_tpu.example import mixture as jm
    from binf_tpu.example import polynomial as jp
    from binf_tpu.example import statespace as js
    from binf_tpu.pdf.transforms import LogTransform as JLog
    from binf_tpu.pdf.transforms import transform_logdensity as jtransform
    from binf_tpu_torch.example import hierarchical, logistic, mixture, polynomial, statespace
    from binf_tpu_torch.pdf.transforms import LogTransform, transform_logdensity

    def n(x):
        return np.asarray(x, np.float32)

    out = {}
    xs, ys = jp.make_data(jax.random.key(1))
    jpost, tpost = jp.make_posterior(xs, ys), polynomial.make_posterior(
        torch.tensor(n(xs)), torch.tensor(n(ys)))
    out["polynomial"] = (jtransform(jpost.log_prob, {"precision": JLog}),
                         transform_logdensity(tpost.log_prob, {"precision": LogTransform}),
                         {"coefficients": (4,), "precision": ()})
    X, y = jl.synthetic_logistic_data(jax.random.key(0))
    jpost = jl.make_logistic_posterior(X, y)
    tpost = logistic.make_logistic_posterior(n(X), n(y), device="cpu")
    out["logistic"] = (jpost.log_prob, tpost.log_prob, {"weights": (X.shape[1],)})
    x, yh, counts, _ = jh.synthetic_hierarchical_data(jax.random.key(0), 8)
    jpost = jh.make_hierarchical_posterior(x, yh, counts, 8)
    tpost = hierarchical.make_hierarchical_posterior(n(x), n(yh), n(counts), 8, device="cpu")
    out["hierarchical"] = (jtransform(jpost.log_prob, {"precision": JLog}),
                           transform_logdensity(tpost.log_prob, {"precision": LogTransform}),
                           {"group_params": (8, 2), "log_tau": (2,), "mu": (2,),
                            "precision": ()})
    ym = jm.synthetic_mixture_data(jax.random.key(0), 64)
    jpost, tpost = jm.make_mixture_posterior(ym), mixture.make_mixture_posterior(n(ym),
                                                                                device="cpu")
    out["mixture"] = (jpost.log_prob, tpost.log_prob,
                      {"log_sigma": (), "log_weights": (3,), "means": (3,)})
    ya = js.synthetic_ar1_data(jax.random.key(0), 32)
    jpost, tpost = js.make_ar1_posterior(ya), statespace.make_ar1_posterior(n(ya), device="cpu")
    out["statespace"] = (jtransform(jpost.log_prob, {"precision": JLog}),
                         transform_logdensity(tpost.log_prob, {"precision": LogTransform}),
                         {"dynamics": (3,), "precision": ()})
    out["random_effects"] = (_jax_random_effects, _torch_random_effects,
                             {"boundaries": (12,), "effects": (4,)})
    return out


MODELS = _models()


def _unpack_jax(q, shapes):
    pos, at = {}, 0
    for k in sorted(shapes):
        size = int(np.prod(shapes[k]))
        pos[k] = q[at:at + size].reshape(shapes[k])
        at += size
    return pos


def _points(D: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((P, D)).astype(np.float32)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Every case compiled, and one host library of all their functors."""
    compiled = {}
    for name, (D, _, tfn) in CASES.items():
        compiled[name] = dc.compile_density(lambda p, tfn=tfn: tfn(p["q"]),
                                            {"q": torch.zeros(D)})
    for name, (_, tfn, shapes) in MODELS.items():
        compiled[name] = dc.compile_density(tfn, {k: torch.zeros(s) for k, s in shapes.items()})
    lib = dc.build_host_library(list(compiled.values()), tmp_path_factory.mktemp("traced"))
    return compiled, lib


def _check(U, g, U_ref, g_ref, rtol=RTOL):
    scale_u = max(float(np.abs(U_ref).max()), 1e-30)
    scale_g = max(float(np.abs(g_ref).max()), 1e-30)
    assert np.all(np.isfinite(U)) and np.all(np.isfinite(g))
    assert float(np.abs(U - U_ref).max()) <= rtol * scale_u, (U, U_ref)
    assert float(np.abs(g - g_ref).max()) <= rtol * scale_g, (g, g_ref)


@pytest.mark.parametrize("name", list(CASES))
def test_interpreter_case_matches_jax(built, name):
    compiled, lib = built
    D, jfn, _ = CASES[name]
    q = _points(D, 100 + list(CASES).index(name))
    U, g = dc.host_eval(lib, compiled[name], q)
    f_ref, g_ref = jax.vmap(jax.value_and_grad(jfn))(jnp.asarray(q))
    # the functor's potential is minus the log density
    _check(U, g, -np.asarray(f_ref), -np.asarray(g_ref))


@pytest.mark.parametrize("name", list(MODELS))
def test_model_case_matches_jax(built, name):
    compiled, lib = built
    jfn, _, shapes = MODELS[name]
    D = compiled[name].D
    q = 0.5 * _points(D, 200 + list(MODELS).index(name))
    U, g = dc.host_eval(lib, compiled[name], q)
    f_ref, g_ref = jax.vmap(jax.value_and_grad(lambda v: jfn(_unpack_jax(v, shapes))))(
        jnp.asarray(q))
    _check(U, g, -np.asarray(f_ref), -np.asarray(g_ref))


def test_random_effects_matches_the_tile_potential(built):
    """The per-chain assignment model against the JAX package's own fused
    front end: ``tile_potential_from_scalar``'s ``tile_value_and_grad`` on
    the same points (lanes of one tile)."""
    from binf_tpu.ops.pallas.fused_potential import _pad_const, tile_potential_from_scalar

    compiled, lib = built
    template = {"boundaries": jnp.zeros(12), "effects": jnp.zeros(4)}
    potential, consts, spec = tile_potential_from_scalar(_jax_random_effects, template)
    q = 0.5 * _points(16, 300)
    padded = {k: _pad_const(v) for k, v in consts.items()}
    U_t, G_t = potential.tile_value_and_grad(jnp.asarray(q.T), padded)
    U, g = dc.host_eval(lib, compiled["random_effects"], q)
    _check(U, g, np.asarray(U_t)[0], np.asarray(G_t)[:16].T)


def test_loop_fusion_streams_the_data_rows(built):
    """The logistic model's likelihood and its gradient are one loop over
    its 200 rows with scalar temporaries: no per-chain array exists, and
    the loop is the only one."""
    src = built[0]["logistic"].source
    assert src.count("for (int") == 1 and "[200]" not in src
    assert built[0]["logistic"].flops > 0


def _while(q):
    """test_unsupported_primitive_raises: a data-dependent trip count."""
    x = q
    while x.sum() < 100.0:
        x = x + 1.0
    return x[0]


@pytest.mark.parametrize("name, fn, D, match", [
    ("eigvalsh", lambda q: torch.linalg.eigvalsh(q.reshape(2, 2) @ q.reshape(2, 2).T).sum(), 4,
     "aten._linalg_eigh"),
    ("data_dependent_if", lambda q: q.sum() if q[0] > 0 else -q.sum(), 3,
     "data-dependent control flow"),
    ("while_loop", lambda q: _while(q), 4, "data-dependent"),
    # the first position past the wide form's cap (the id names the one-lane
    # cap it was written for)
    ("d33", lambda q: -0.5 * (q ** 2).sum(), dc.MAX_D_WIDE + 1, f"at most {dc.MAX_D_WIDE}"),
], ids=["eigvalsh", "data_dependent_if", "while_loop", "d33"])
def test_refusals(name, fn, D, match):
    with pytest.raises(UnsupportedOpError, match=match):
        dc.compile_density(lambda p: fn(p["q"]), {"q": torch.zeros(D)})
    assert issubclass(UnsupportedOpError, NotImplementedError)


def test_node_cap(monkeypatch):
    """A graph past the node cap is refused by name (the cap bounds nvcc's
    time); the same density compiles under the default cap."""
    fn = {"q": torch.zeros(4)}
    dc.compile_density(lambda p: _torch_ar(p["q"]), fn)
    monkeypatch.setattr(dc, "NODE_CAP", 20)
    with pytest.raises(UnsupportedOpError, match="past the 20"):
        dc.compile_density(lambda p: _torch_ar(p["q"]), fn)


def test_key_is_the_graph_not_the_data():
    """A new data set of the same shapes gives the same emitted functor
    (the same key, other operands); other shapes give another."""
    def model(y):
        return lambda p: -0.5 * torch.sum((y - p["m"]) ** 2) - 0.5 * torch.sum(p["m"] ** 2)

    t = {"m": torch.zeros(())}
    a = dc.compile_density(model(torch.arange(40.0)), t)
    b = dc.compile_density(model(torch.linspace(-1.0, 1.0, 40)), t)
    c = dc.compile_density(model(torch.arange(41.0)), t)
    assert a.key == b.key and a.source == b.source
    assert not torch.equal(a.operands, b.operands)
    assert c.key != a.key
