"""K7 over any density the density compiler lowers, on the CPU.

(a) The chain-grid potential of a traced callable against the JAX
package's ``chain_grid_potential_from_scalar(...).value_and_grad`` on the
two densities of ``tests/test_chain_grid.py`` (the mixed-rank Gaussian and
the sequential density with a matvec in its scan body, the same constants),
at positions drawn by numpy from a seed: U within 1e-6 relative, the
gradient within 1e-5.

(b) The group form of the emitted functor (``TracedGroup_<key>``, the entry
K7 runs), built with ``g++`` through ``csrc/host_compat.h`` and run by a
group of G = 1, 4 and 32 host threads meeting at a barrier, on those two
densities, a log-sum-exp over data rows (its split maximum and sum), and
the five CLI models K7 had no functor for: within 1e-5 of the largest |U|
and |grad U| over 64 positions of ``torch.func`` and of the one-lane
functor, every thread's U the same bits.

(c) K7's plain version on the Gaussian's traced potential against the JAX
interpret-mode kernel step by step on the same host noise (``noise=``):
the float32 trajectories part only by rounding, no MH decision lies within
1e-3 of its threshold (asserted), the draws within 2e-4.

(d) The one-lane text K3 and K4 take is unchanged by the group form: the
keys (the hash of the one-lane text) of the traced models of
``tests/test_torch_traced_models.py`` are the ones the compiler gave before
the group form existed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binf_tpu.ops.pallas.chain_grid import chain_grid_hmc_run as jax_run
from binf_tpu.ops.pallas.chain_grid import chain_grid_potential_from_scalar as jax_potential
from binf_tpu.ops.pallas.fused_potential import _pad_const
from binf_tpu_torch.ops.kernels import density_compiler as dc
from binf_tpu_torch.ops.kernels.chain_grid import (
    TracedPotential,
    chain_grid_hmc_plain,
    chain_grid_potential_from_scalar,
    group_value_and_grad,
)
from binf_tpu_torch.ops.kernels.densities import CallableDensity
from binf_tpu_torch.ops.kernels.fused_potential import pack_positions

GROUPS = (1, 4, 32)
POINTS = 64
GROUP_TOL = 1e-5  # of the largest |U| and |grad U|
CLI_MODELS = ("polynomial", "hierarchical", "logistic", "statespace", "mixture")
# the one-lane keys of tests/test_torch_traced_models.py's models, as the
# compiler emitted them before the group form
ONE_LANE_KEYS = {"student_t": "d60d9f760d5e8677", "laplace": "78b923e3e64ba270",
                 "poisson": "f45973f271ec1bef", "bernoulli": "f7c38d2e50415e15",
                 "lognormal": "3abafb8f582da64a", "gamma": "efcbaa16739cd1ad",
                 "sigmoid_uniform": "7b7c2377912d08f1"}

# -- tests/test_chain_grid.py's densities, in JAX and in torch ------------------------

M = np.arange(6.0, dtype=np.float32).reshape(3, 2)
A = np.array([[0.6, 0.2], [0.0, 0.5]], np.float32)
Y = np.asarray(0.3 * jax.random.normal(jax.random.key(9), (12, 2)), np.float32)


def _jax_gaussian(p):
    return -0.5 * jnp.sum((p["x"] - jnp.asarray(M)) ** 2 / 0.25) - 0.5 * p["y"] ** 2


def _torch_gaussian(p):
    return -0.5 * torch.sum((p["x"] - torch.tensor(M)) ** 2 / 0.25) - 0.5 * p["y"] ** 2


def _jax_sequential(p):
    x0 = p["x0"]

    def body(x, y_t):
        x = jnp.asarray(A) @ x
        return x, jnp.sum((y_t - x) ** 2)

    _, sq = jax.lax.scan(body, x0, jnp.asarray(Y))
    return -0.5 * jnp.sum(sq) - 0.5 * jnp.sum(x0 ** 2)


def _torch_sequential(p):
    x = p["x0"]
    sq = []
    for t in range(Y.shape[0]):
        x = torch.tensor(A) @ x
        sq.append(torch.sum((torch.tensor(Y[t]) - x) ** 2))
    return -0.5 * torch.sum(torch.stack(sq)) - 0.5 * torch.sum(p["x0"] ** 2)


ROWS = np.random.default_rng(5).standard_normal((100, 3)).astype(np.float32)


def _torch_lse_rows(p):
    """A log-sum-exp and a minimum over 100 data rows: the group form
    splits the maximum, the sum of exponentials and the minimum."""
    s = torch.tensor(ROWS) @ p["w"]
    return -torch.logsumexp(s, 0) + 0.1 * torch.amin(s) - 0.5 * torch.sum(p["w"] ** 2)


TEMPLATES = {"gaussian": ({"x": (3, 2), "y": ()}, _jax_gaussian, _torch_gaussian),
             "sequential": ({"x0": (2,)}, _jax_sequential, _torch_sequential)}


def _positions(shapes, n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((n,) + s).astype(np.float32) for k, s in shapes.items()}


def _cli_model(name):
    from binf_tpu_torch import cli
    from binf_tpu_torch.pdf.transforms import unconstrain

    model = cli.build_model(name, torch.Generator().manual_seed(0), device="cpu")
    start = unconstrain(model.transforms,
                        model.init_fn(POINTS, generator=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(2)
    start = {k: v + 0.1 * torch.tensor(rng.standard_normal(tuple(v.shape)), dtype=v.dtype)
             for k, v in start.items()}
    return cli._logdensity(model), start


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_traced_potential_matches_jax(name):
    shapes, jax_ld, torch_ld = TEMPLATES[name]
    template = {k: torch.zeros(s) for k, s in shapes.items()}
    pot, consts, spec = chain_grid_potential_from_scalar(torch_ld, template)
    assert isinstance(pot, TracedPotential) and consts == {}
    assert [s[0] for s in spec] == sorted(shapes)
    jpot, jconsts, _ = jax_potential(jax_ld, {k: jnp.zeros(s) for k, s in shapes.items()})
    kc = {k: _pad_const(v) for k, v in jconsts.items()}
    pos = _positions(shapes, 8, 11)
    U, g = pot.potential_and_grad({k: torch.tensor(v) for k, v in pos.items()})
    for i in range(8):
        u_ref, g_ref = jpot.value_and_grad({k: jnp.asarray(v[i]) for k, v in pos.items()}, kc)
        np.testing.assert_allclose(float(U[i]), float(u_ref), rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(g[k][i].numpy(), np.asarray(g_ref[k]), rtol=1e-5,
                                       atol=1e-5 * float(np.abs(np.asarray(g_ref[k])).max()))


@pytest.fixture(scope="module")
def group_cases(tmp_path_factory):
    """name -> (CompiledDensity, log density, positions (POINTS, D)), and
    the host library of every functor's two entries."""
    cases = {}
    for name, (shapes, _, torch_ld) in TEMPLATES.items():
        q = _positions(shapes, POINTS, 12)
        cases[name] = (torch_ld, {k: torch.tensor(v) for k, v in q.items()})
    cases["lse_rows"] = (_torch_lse_rows, {"w": torch.tensor(_positions({"w": (3,)}, POINTS,
                                                                         13)["w"])})
    for name in CLI_MODELS:
        cases[name] = _cli_model(name)
    built = {}
    for name, (ld, start) in cases.items():
        template = {k: v[0] for k, v in start.items()}
        cd = dc.compile_density(ld, template)
        built[name] = (cd, ld, template, pack_positions(start).numpy())
    lib = dc.build_host_library([b[0] for b in built.values()],
                                tmp_path_factory.mktemp("chain_grid_traced"))
    return built, lib


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("name", [*TEMPLATES, "lse_rows", *CLI_MODELS])
def test_group_form_on_host_threads(group_cases, name, G):
    built, lib = group_cases
    cd, ld, template, q = built[name]
    assert cd.group_name == f"TracedGroup_{cd.key}" and cd.group_name in cd.header
    U, g = dc.host_eval(lib, cd, q, threads=G)  # raises if a thread's U differs
    U1, g1 = dc.host_eval(lib, cd, q)
    Uf, gf = CallableDensity(ld, template).potential_and_grad(torch.tensor(q))
    Uf, gf = Uf.numpy(), gf.numpy()
    assert np.isfinite(U).all() and np.isfinite(g).all()
    for ref_U, ref_g in ((Uf, gf), (U1, g1)):
        assert np.abs(U - ref_U).max() <= GROUP_TOL * np.abs(ref_U).max()
        assert np.abs(g - ref_g).max() <= GROUP_TOL * np.abs(ref_g).max()
    if G == 1:  # one thread walks every row in the one-lane order
        assert np.array_equal(U, U1) and np.array_equal(g, g1)


def test_group_form_splits_the_row_loops(group_cases):
    """The loops over data rows stride over the group; densities without
    one (every nest unrolled) are computed whole in every thread."""
    built, _ = group_cases
    rows = {name: b[0].group_rows for name, b in built.items()}
    assert rows == {"gaussian": 0, "sequential": 0, "lse_rows": 100, "polynomial": 0,
                    "hierarchical": 120, "logistic": 200, "statespace": 64, "mixture": 240}
    lse = built["lse_rows"][0].group_source
    assert "grp.max(" in lse and "grp.sum(" in lse and "grp.min(" in lse
    assert "grp.T" not in built["polynomial"][0].group_source


def test_entry_on_the_cpu_is_the_plain_version(group_cases):
    built, _ = group_cases
    cd, ld, template, q = built["logistic"]
    pot, _, _ = chain_grid_potential_from_scalar(ld, template)
    assert pot.compiled.key == cd.key
    U, g = group_value_and_grad(pot, torch.tensor(q[:8]))
    Uf, gf = CallableDensity(ld, template).potential_and_grad(torch.tensor(q[:8]))
    assert torch.equal(U, Uf) and torch.equal(g, gf)


def test_plain_run_matches_jax_interpret():
    """K7's plain version on the traced Gaussian against the JAX
    interpret-mode kernel, 20 steps of 8 chains on the JAX host noise."""
    shapes, jax_ld, torch_ld = TEMPLATES["gaussian"]
    C, steps, leap, seed = 8, 20, 5, 3
    pot, _, _ = chain_grid_potential_from_scalar(torch_ld,
                                                 {k: torch.zeros(s) for k, s in shapes.items()})
    jpot, jconsts, _ = jax_potential(jax_ld, {k: jnp.zeros(s) for k, s in shapes.items()})
    q0 = _positions(shapes, C, 14)
    eps = np.linspace(0.15, 0.3, C).astype(np.float32)
    im = {"x": np.full((3, 2), 0.25, np.float32), "y": np.float32(1.0)}
    jr = jax_run(jpot, {k: jnp.asarray(v) for k, v in q0.items()}, seed, jnp.asarray(eps),
                 {k: jnp.asarray(v) for k, v in im.items()}, jconsts, num_steps=steps,
                 num_leapfrog=leap, block_chains=C, steps_per_block=10, interpret=True,
                 host_noise=True)
    # the JAX kernel's host noise (chain_grid.py:536-547): a key a variable
    # in sorted-name order, then the uniforms
    keys = jax.random.split(jax.random.key(jnp.asarray(seed, jnp.uint32)), 3)
    mom = [np.asarray(jax.random.normal(keys[v], (steps, C) + s, jnp.float32))
           for v, s in enumerate([(3, 2), (1, 1)])]
    unif = np.asarray(jax.random.uniform(keys[-1], (steps, C, 1), jnp.float32))
    trace = chain_grid_hmc_plain(pot, {k: torch.tensor(v) for k, v in q0.items()}, seed,
                                 torch.tensor(eps), im, num_steps=steps, num_leapfrog=leap,
                                 noise=([torch.tensor(m) for m in mom], torch.tensor(unif)))
    assert float(trace.margin.abs().min()) > 1e-3
    got = trace.result
    assert 0.3 < float(got.accept_rate) < 1.0
    assert float(got.accept_rate) == pytest.approx(float(jr.accept_rate), abs=1e-6)
    for k in shapes:
        assert got.draws[k].shape == jr.draws[k].shape
        np.testing.assert_allclose(got.draws[k].numpy(), np.asarray(jr.draws[k]), atol=2e-4)
        np.testing.assert_allclose(got.final_positions[k].numpy(),
                                   np.asarray(jr.final_positions[k]), atol=2e-4)


@pytest.mark.parametrize("name", sorted(ONE_LANE_KEYS))
def test_one_lane_text_is_unchanged(name):
    import test_torch_traced_models as traced_models

    fn, shapes = traced_models.build(traced_models.TORCH, name)
    cd = dc.compile_density(fn, {k: torch.zeros(s) for k, s in shapes.items()})
    assert cd.key == ONE_LANE_KEYS[name] and cd.name == f"Traced_{cd.key}"
    assert "TracedGroup_" not in cd.source and cd.header.startswith(cd.source)


def test_k7_unit_build_with_a_stand_in_compiler(tmp_path, monkeypatch):
    """``chain_grid_library`` compiles a traced density's K7 unit
    (``csrc/chain_grid_shape.cu``, which carries the entry points the
    wrappers bind) with the emitted header, both entries, force-included and
    its group form named, into the hashed build directory, once; the seconds
    go to ``SHAPE_BUILDS`` under the library's name."""
    import stat
    import sys

    from binf_tpu_torch.ops.kernels import _build

    unit = (_build.CSRC / "chain_grid_shape.cu").read_text()
    assert "binf_chain_grid_traced_hmc(" in unit and "binf_group_eval(" in unit
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n"
                    "import sys\n"
                    "args = sys.argv[1:]\n"
                    "open(args[args.index('-o') + 1], 'w').write(' '.join(args))\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "SHAPE_BUILDS", {})
    monkeypatch.setattr(_build, "_shapes_ready", set())
    shapes, _, torch_ld = TEMPLATES["sequential"]
    cd = dc.compile_density(torch_ld, {k: torch.zeros(s) for k, s in shapes.items()})
    name = _build.chain_grid_library(cd)
    assert name == f"chain_grid_shape.{cd.key}.d2"
    args = (_build.build_dir() / f"lib{name}.so").read_text().split()
    header = args[args.index("-include") + 1]
    assert open(header).read() == cd.header
    assert f"-DBINF_TRACED_TYPE=binf::{cd.group_name}" in args
    assert args[-1] == str(_build.CSRC / "chain_grid_shape.cu")
    assert set(_build.SHAPE_BUILDS) == {name}
    (_build.build_dir() / f"lib{name}.so").write_text("built")
    assert _build.chain_grid_library(cd) == name
    assert (_build.build_dir() / f"lib{name}.so").read_text() == "built"
