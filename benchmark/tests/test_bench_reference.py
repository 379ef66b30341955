"""The plain references against the port at small sizes on the CPU: each
piece (the control networks, the target, the GMM reference's score, the
time grid and the integrator's coefficients, the noise), then the checks
of a whole run."""
import math

import pytest
import torch

from benchlib import weights
from reference import gmm, many_modes_d8, mnist_unet, nice, philox, precision, unet, vp

F32 = precision.Arith("f32")
F64 = precision.Arith("f64")


def test_tf32_rounds_to_ten_mantissa_bits_to_nearest_even():
    one = torch.tensor([1.0])
    ulp = 2.0**-10
    x = torch.tensor([1.0 + ulp / 4, 1.0 + 3 * ulp / 4, 1.0 + ulp / 2, 1.0 + 3 * ulp / 2, -1.0 - ulp / 4])
    assert precision.tf32(x).tolist() == [1.0, 1.0 + ulp, 1.0, 1.0 + 2 * ulp, -1.0]
    assert precision.tf32(one).item() == 1.0


def test_tf32_control_keeps_the_gradient():
    w = torch.randn(4, 3, requires_grad=True)
    precision.Arith("tf32").mm(torch.randn(2, 4), w).sum().backward()
    assert w.grad is not None and w.grad.abs().sum() > 0


def test_unet_reference_matches_the_port():
    from sde_sampler_lrds_torch.models.mnist_unet import Unet

    m = Unet(n_channels=16, side=14)
    W = weights.draw(weights.unet_shapes(16), torch.Generator().manual_seed(3),
                     ("proj_convs.0.weight", "proj_convs.0.bias"), 0.1)
    weights.load_into(m, W)
    x, t = torch.randn(6, 196), torch.rand(6)
    with torch.no_grad():
        want = m(t, x)
    assert torch.allclose(unet.unet(W, t, x, F32), want, atol=1e-5, rtol=1e-5)


def test_fourier_mlp_reference_matches_the_port():
    from sde_sampler_lrds_torch.models.mlp import FourierMLP

    m = FourierMLP(dim=8, channels=64, num_layers=4)
    W = weights.draw(weights.fourier_mlp_shapes(8, 64, 4), torch.Generator().manual_seed(4),
                     ("out.weight", "out.bias"), 0.3)
    weights.load_into(m, W)
    x, t = torch.randn(10, 8), torch.tensor(0.37)
    with torch.no_grad():
        want = m(t, x).double()
    got = many_modes_d8.mlp({k: v.double() for k, v in W.items()}, t.double(), x.double(), F64, 2)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


def test_log_snr_grid_and_ei_coefficients_match_the_ports():
    from sde_sampler_lrds_torch.losses import EIReferenceSDELoss
    from sde_sampler_lrds_torch.sde import VP as PortVP
    from sde_sampler_lrds_torch.utils.common import get_timesteps

    for beta_max in (10.0, 20.0):
        port = PortVP(diff_coeff_sq_min=0.1, diff_coeff_sq_max=beta_max)
        ts = get_timesteps(1e-4, 1.0 - 1e-4, steps=100, sde=port, device="cpu")
        ref = vp.VP(0.1, beta_max)
        mine = ref.snr_grid(100, 1e-4)
        assert torch.allclose(mine, ts, rtol=1e-6, atol=0)
        loss = EIReferenceSDELoss(sde=port, method="lv")
        t_ctrl, a_x, a_s, a_z, omega = ref.ei_coeffs(ts)
        p_ax, p_as, p_az = loss._step_coeffs(ts[:-1], ts[1:])
        # the port holds them in float32: its Δα of two α near 10 cancels
        for got, want in ((p_ax, a_x), (p_as, a_s), (p_az, a_z), (loss._omega(ts[:-1], ts[1:]), omega)):
            assert torch.allclose(got.double(), want, rtol=5e-3, atol=0)
        assert torch.allclose(t_ctrl.float(), ts[-1] - ts[:-1])


@pytest.mark.parametrize("full", [False, True])
def test_noised_gmm_score_matches_the_ports_reference(full):
    from sde_sampler_lrds_torch.sde import VP as PortVP
    from sde_sampler_lrds_torch.solvers import GMMReferenceCtrl

    g = torch.Generator().manual_seed(5)
    c, d = 3, 6
    w = torch.rand(c, generator=g) + 0.5
    m = torch.randn(c, d, generator=g)
    if full:
        a = torch.randn(c, d, d, generator=g)
        v = a @ a.transpose(1, 2) / d + 0.1 * torch.eye(d)
    else:
        v = 0.3 + torch.rand(c, d, generator=g)
    port = GMMReferenceCtrl(PortVP(0.1, 10.0), m, v, w)
    t = torch.tensor([0.3, 0.8])
    tab = port.precompute(t)
    x = torch.randn(7, d, generator=g)
    mix = gmm.Mixture(w, m, v, F64)
    ref = vp.VP(0.1, 10.0)
    for k in range(2):
        want = port.apply(tuple(a[k] if not isinstance(a, tuple) else tuple(b[k] for b in a)
                                for a in tab), x)
        tk = t[k].double()
        got = mix.noised_score(x.double(), ref.s(tk), ref.sigma_sq(tk))
        assert torch.allclose(got, want.double(), rtol=1e-4, atol=1e-4)


def test_nice_mixture_matches_the_ports_target():
    from sde_sampler_lrds_torch.targets.nice import MixtureNice

    port = MixtureNice(digits=(0, 1), device="cpu")
    target = nice.MixtureTarget((0, 1), torch.device("cpu"), F64)
    x = port.sample(torch.Generator().manual_seed(6), (5,))
    got = target.log_prob(x.double())
    want = port.unnorm_log_prob(x).double()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-2)


def test_many_modes_target_matches_the_ports():
    from sde_sampler_lrds_torch.targets import ManyModes

    spec = {"n_modes": 4, "dim": 8, "var": 0.5, "mixture_weight_factor": 3.0, "seed_loc": 42}
    port = ManyModes(n_modes=4, dim=8, var=0.5, device="cpu")
    x = port.sample(torch.Generator().manual_seed(7), (9,))
    got = many_modes_d8.target_log_prob(spec, x.double())
    assert torch.allclose(got, port.unnorm_log_prob(x).double(), rtol=1e-5, atol=1e-5)


def test_philox_copy_matches_chip_smoke():
    import chip_smoke

    traj = torch.arange(64).repeat_interleave(8)
    dims = torch.arange(8).repeat(64)
    for seed, step in ((0x5EED_0000 + 7, 0), (2**62 - 12345, 99)):
        assert torch.equal(philox.philox_normals(seed, step, traj, dims),
                           chip_smoke.philox_normals(seed, step, traj, dims))
    z = philox.step_normals(123, 3, torch.arange(4096), 8)
    assert abs(float(z.mean())) < 0.03 and abs(float(z.var()) - 1) < 0.05


def test_gradient_in_blocks_is_the_gradient_of_the_variance():
    """The reference's blockwise gradient of Var(rnd) equals autograd's
    through the whole batch at once."""
    g = torch.Generator().manual_seed(8)
    a = torch.randn(5, 3, generator=g, dtype=torch.float64, requires_grad=True)
    xs = torch.randn(4, 5, 3, generator=g, dtype=torch.float64)      # (K, B, D)
    u = lambda x: torch.tanh(x * a)
    rnd = torch.stack([(u(xs[k]) ** 2).sum(-1) for k in range(4)]).sum(0)
    (want,) = torch.autograd.grad(rnd.var(correction=1), a)
    weight = 2.0 * (rnd.detach() - rnd.detach().mean()) / (rnd.shape[0] - 1)
    total = torch.zeros_like(a)
    for lo in (0, 2):
        part = torch.stack([(u(xs[k]) ** 2).sum(-1) for k in range(lo, lo + 2)]).sum(0)
        (gp,) = torch.autograd.grad((part * weight).sum(), a)
        total += gp
    assert torch.allclose(total, want)


def test_leaf_gaps_by_the_median_leaf_and_the_moved_leaves():
    ref = {"grad": {"a": torch.ones(4), "b": torch.ones(4) * 2, "c": torch.zeros(4),
                    "q": torch.tensor([1.0, 1e-9, -1.0, 1.0])}}
    moved = mnist_unet.moved_elements(ref)
    assert sorted(moved) == ["a", "b", "q"] and moved["q"].tolist() == [True, False, True, True]
    gaps = mnist_unet.leaf_gaps({"a": torch.ones(4) * 1.1, "b": torch.ones(4) * 2},
                                {"a": torch.ones(4), "b": torch.ones(4) * 2},
                                {"a": None, "b": None})
    # the median of an even count is the lower middle norm (torch.median): 2
    assert gaps["b"] == 0.0 and math.isclose(gaps["a"], 0.2 / 2.0, rel_tol=1e-6)
    # an element left out does not count: only the others' change is compared
    q = mnist_unet.leaf_gaps({"q": torch.tensor([1.0, 5.0, 1.0, 1.0])},
                             {"q": torch.tensor([1.0, -5.0, 1.0, 1.0])}, {"q": moved["q"]})
    assert q == {"q": 0.0}


def test_a_leaf_the_reference_leaves_still_reads_a_program_that_moves_it():
    zero, one = {"a": torch.zeros(3)}, {"a": torch.ones(3)}
    assert mnist_unet.leaf_gaps(one, zero, {"a": None}) == {"a": math.inf}
    assert mnist_unet.leaf_gaps(zero, zero, {"a": None}) == {"a": 0.0}


def test_a_batch_the_loss_filters_whole_is_not_correct():
    """When every trajectory exceeds max_rnd (or is NaN), the reference's
    loss and gradient are zero and nothing moves: there is nothing to
    compare, and every number reads infinite, whatever the program did."""
    zero = {"a": torch.zeros(3), "b": torch.zeros(2)}
    side = {"losses": [0.0, 0.0, 0.0], "grad": zero, "before": zero, "after": zero}
    assert not mnist_unet.live(side)
    assert all(math.isinf(v) for v in mnist_unet.gaps(side, side).values())


def test_the_flow_draws_stay_finite_where_a_uniform_rounds_to_one():
    """At this seed and size one uniform of the fit's draws lies within
    2^-25 of 1; its logistic latent, taken in float32, was infinite and
    made the fitted GMM NaN."""
    from benchlib.util import sub_seed

    target = nice.MixtureTarget((0, 1), torch.device("cpu"), F32)
    g = torch.Generator().manual_seed(sub_seed(3_000_000_019, "gmm"))
    w, m, (eig, p) = nice.fit_reference(target, g, 2000, 0.01)
    assert all(bool(torch.isfinite(a).all()) for a in (w, m, eig, p))
    assert float(eig.min()) > 1e-4
