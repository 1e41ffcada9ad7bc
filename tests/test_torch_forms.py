"""The custom-form compiler of the PyTorch port (``fem/forms.py``) against
the factored assembler of the port and the JAX package's ``FormCompiler``,
on the CPU in f64.

The forms are built once per package from one function that takes the
package's forms module, so both compilers see the same expression trees.
Every operator and vector below is held within 1e-12 relative (max-norm)
of the port's ``NSAssembler`` and of the JAX ``FormCompiler`` at the same
random iterate:

  * the level-0 step (2D): Mp, Ap, Kp with the BRM2 inflow surface term,
    the four blocks of the mixed Picard Jacobian, the residual linear form,
    the Newton reaction, and linear forms with facet terms (the vector
    scatters over a boundary marker);
  * the level-0 duct (3D, quadrature degree 4 as the 3D models use): Mp,
    Ap, Kp with the inflow face term, the uu block.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fenapack_tpu_torch.fem import forms as TF
from fenapack_tpu_torch.fem import mesh as tmesh
from fenapack_tpu_torch.fem.assemble import NSAssembler
from fenapack_tpu_torch.models import Duct3D

NU = 0.02
NU3 = 0.1
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _forms(F, W, mesh, nu, inflow):
    """Every form the tests assemble, in the mini-UFL of module ``F``."""
    (u, p) = F.TrialFunctions(W)
    (v, q) = F.TestFunctions(W)
    w = F.Coefficient(W, "w")
    u_, p_ = F.split(w)
    n = F.FacetNormal(mesh)
    return {
        "mp": (1.0 / nu) * p * q * F.dx,
        "ap": F.inner(F.grad(p), F.grad(q)) * F.dx,
        "kp": ((1.0 / nu) * F.dot(F.grad(p), u_) * q * F.dx
               - (1.0 / nu) * F.dot(u_, n) * p * q * F.ds(inflow)),
        "J": (nu * F.inner(F.grad(u), F.grad(v)) * F.dx
              + F.inner(F.dot(F.grad(u), u_), v) * F.dx
              - p * F.div(v) * F.dx
              - q * F.div(u) * F.dx),
        "L": (nu * F.inner(F.grad(u_), F.grad(v)) * F.dx
              + F.inner(F.dot(F.grad(u_), u_), v) * F.dx
              - p_ * F.div(v) * F.dx
              - q * F.div(u_) * F.dx),
        "Jr": F.inner(F.dot(F.grad(u_), u), v) * F.dx,
        # facet terms of linear forms: a traction-like load on the outflow
        # and a flux through the inflow, beside a cell term
        "Ls": (F.inner(u_, v) * F.ds(tmesh.OUTFLOW)
               + p_ * F.dot(v, n) * F.ds(tmesh.OUTFLOW)
               + F.dot(u_, n) * q * F.ds(inflow)
               + 0.5 * F.dot(u_, v) * F.dx),
    }


def _jax_dense(fc, test, trial, vals):
    pat = fc.pattern(test, trial)
    return np.asarray(pat.to_scipy(pat.matrix(vals)).todense())


def _dense(fc, test, trial, vals):
    return fc.pattern(test, trial).to_dense(vals).numpy()


@pytest.fixture(scope="module")
def step2d():
    """(port assembler, port compiler and forms, JAX compiler and forms,
    random iterate) on the level-0 step."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import forms as JF
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.dofmap import TaylorHood as JTH
    mesh = tmesh.backward_step_mesh(0)
    asm = NSAssembler(mesh, NU, device="cpu")
    fc = TF.FormCompiler(asm.W, quad_degree=5, device="cpu")
    jm = jmesh.backward_step_mesh(0)
    jfc = JF.FormCompiler(JTH(jm), quad_degree=5)
    rng = np.random.default_rng(3)
    w = rng.standard_normal(asm.W.dim)
    return dict(asm=asm, fc=fc, f=_forms(TF, asm.W, mesh, NU, tmesh.INFLOW),
                jfc=jfc, jf=_forms(JF, jfc.W, jm, NU, jmesh.INFLOW),
                w=w, tw={"w": torch.as_tensor(w)}, jw={"w": jnp.asarray(w)})


def _check_block(s, name, test, trial, ref):
    got = _dense(s["fc"], test, trial,
                 s["fc"].assemble_block(s["f"][name], test, trial,
                                        coeffs=s["tw"]))
    jref = _jax_dense(s["jfc"], test, trial,
                      s["jfc"].assemble_block(s["jf"][name], test, trial,
                                              coeffs=s["jw"]))
    assert _rel(got, jref) <= TOL
    if ref is not None:
        assert _rel(got, ref) <= TOL


# --------------------------------------------------------------------- #
# 2D: the level-0 step
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ["mp", "ap", "kp"])
def test_pressure_forms(step2d, name):
    """Mp, Ap and Kp with the BRM2 inflow surface term against the
    factored operators (Mp scaled by 1/nu, Ap unscaled)."""
    asm, w = step2d["asm"], torch.as_tensor(step2d["w"])
    ref = {"mp": lambda: asm.const.Mp.vals, "ap": lambda: asm.const.Ap.vals,
           "kp": lambda: asm.kp_values(w[:2 * asm.n2], surface=True)}[name]
    _check_block(step2d, name, "p", "p",
                 asm.pat_p1.to_dense(ref()).numpy())


@pytest.mark.parametrize("block", ["uu", "up", "pu", "pp"])
def test_mixed_jacobian_blocks(step2d, block):
    """The Picard (Oseen) mixed form: uu is nu L + N(w) on each component,
    up the stacked gradients DT_a, pu the divergence [D_x, D_y], pp zero."""
    asm = step2d["asm"]
    n2, n1 = asm.n2, asm.n1
    w = torch.as_tensor(step2d["w"])
    dense = lambda pat, vals: pat.to_dense(vals).numpy()
    if block == "uu":
        A1 = dense(asm.pat_p2, asm.picard_matrix_values(w[:2 * n2]))
        ref = np.zeros((2 * n2, 2 * n2))
        ref[:n2, :n2] = ref[n2:, n2:] = A1
    elif block == "up":
        ref = np.concatenate([dense(asm.pat_divT, asm.const.DT[a].vals)
                              for a in range(2)], axis=0)
    elif block == "pu":
        ref = np.concatenate([dense(asm.pat_div, asm.const.D[a].vals)
                              for a in range(2)], axis=1)
    else:
        ref = None
    test, trial = block
    got = step2d["fc"].assemble_block(step2d["f"]["J"], test, trial,
                                      coeffs=step2d["tw"])
    if block == "pp":
        assert got.shape == step2d["fc"].pattern("p", "p").value_shape
        assert float(got.abs().max()) == 0.0 and n1 > 0
    _check_block(step2d, "J", test, trial, ref)


@pytest.mark.parametrize("block", ["u", "p"])
def test_residual_linear_form(step2d, block):
    """The nonlinear residual as a linear form F(w; v, q) against the
    factored residual."""
    asm, n2 = step2d["asm"], step2d["asm"].n2
    w = torch.as_tensor(step2d["w"])
    ru, rp = asm.residual(w[:2 * n2], w[2 * n2:])
    got = step2d["fc"].assemble_vector(step2d["f"]["L"], block,
                                       coeffs=step2d["tw"]).numpy()
    jref = np.asarray(step2d["jfc"].assemble_vector(step2d["jf"]["L"], block,
                                                    coeffs=step2d["jw"]))
    assert _rel(got, (ru if block == "u" else rp).numpy()) <= TOL
    assert _rel(got, jref) <= TOL


def test_newton_reaction_via_forms(step2d):
    """The Newton term inner(grad(w) u, v) against the factored reaction
    blocks R_ab."""
    asm, n2 = step2d["asm"], step2d["asm"].n2
    R = asm.newton_reaction_values(torch.as_tensor(step2d["w"][:2 * n2]))
    ref = np.zeros((2 * n2, 2 * n2))
    for a in range(2):
        for b in range(2):
            ref[a * n2:(a + 1) * n2, b * n2:(b + 1) * n2] = \
                asm.pat_p2.to_dense(R[a, b]).numpy()
    _check_block(step2d, "Jr", "u", "u", ref)


@pytest.mark.parametrize("block", ["u", "p"])
def test_facet_linear_forms(step2d, block):
    """Linear forms with facet terms on two markers beside a cell term:
    the vector sums over each measure against the JAX package."""
    got = step2d["fc"].assemble_vector(step2d["f"]["Ls"], block,
                                       coeffs=step2d["tw"]).numpy()
    jref = np.asarray(step2d["jfc"].assemble_vector(step2d["jf"]["Ls"],
                                                    block,
                                                    coeffs=step2d["jw"]))
    assert np.abs(jref).max() > 0
    assert _rel(got, jref) <= TOL


# --------------------------------------------------------------------- #
# 3D: the level-0 duct
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def duct():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenapack_tpu.fem import forms as JF
    from fenapack_tpu.fem import mesh as jmesh
    from fenapack_tpu.fem.dofmap import TaylorHood as JTH
    from fenapack_tpu.models import Duct3D as JDuct
    asm = Duct3D(level=0, nu=NU3, device="cpu").assembler()
    fc = TF.FormCompiler(asm.W, quad_degree=4, device="cpu")
    jm = JDuct(level=0, nu=NU3).mesh()
    jfc = JF.FormCompiler(JTH(jm), quad_degree=4)
    rng = np.random.default_rng(11)
    w = rng.standard_normal(asm.W.dim)
    return dict(asm=asm, fc=fc,
                f=_forms(TF, asm.W, asm.mesh, NU3, tmesh.INFLOW),
                jfc=jfc, jf=_forms(JF, jfc.W, jm, NU3, jmesh.INFLOW),
                w=w, tw={"w": torch.as_tensor(w)}, jw={"w": jnp.asarray(w)})


@pytest.mark.parametrize("name", ["mp", "ap", "kp", "uu"])
def test_duct_forms(duct, name):
    """Mp, Ap, Kp with the inflow face term (triangle faces) and the uu
    block of the Picard Jacobian on tets."""
    asm = duct["asm"]
    n2 = asm.n2
    w = torch.as_tensor(duct["w"])
    assert asm.dim == 3 and asm.n_inflow_facets > 0
    if name == "uu":
        A1 = asm.pat_p2.to_dense(
            asm.picard_matrix_values(w[:3 * n2])).numpy()
        ref = np.zeros((3 * n2, 3 * n2))
        for a in range(3):
            ref[a * n2:(a + 1) * n2, a * n2:(a + 1) * n2] = A1
        _check_block(duct, "J", "u", "u", ref)
        return
    vals = {"mp": lambda: asm.const.Mp.vals,
            "ap": lambda: asm.const.Ap.vals,
            "kp": lambda: asm.kp_values(w[:3 * n2], surface=True)}[name]()
    _check_block(duct, name, "p", "p", asm.pat_p1.to_dense(vals).numpy())
