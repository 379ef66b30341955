"""The port's own tracing (``utils/profiling.py``): the regions of an
evaluation pass and a training step of a small RDS solver appear in a
``torch.profiler`` trace under their documented names and nesting; with no
profiler recording, no region enters ``record_function``; ``host_read``
returns the number ``item()`` gives and counts each read, 7 in a pass on the
CPU and 1 or 2 in a step. Everything runs on the CPU at small sizes."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sde_sampler_lrds_torch.api import make_model, make_target_details
from sde_sampler_lrds_torch.utils import profiling
from sde_sampler_lrds_torch.utils.profiling import annotate, host_read

DIM, K = 3, 6


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _solver(loss_type="lv", **training):
    details = {"train_steps": 4, "train_batch_size": 16, "eval_batch_size": 32}
    details.update(training)
    solver = make_model(
        solver_type="vp-ref", ref_type="default", loss_type=loss_type, integrator_type="ei",
        model_type="base_zero_init", time_type="snr", solver_details={"sigma": 1.0},
        target_details=make_target_details("two_modes", dim=DIM), training_details=details,
        n_steps=K, use_ema=True, compute_samples_based_metrics=False, device="cpu")
    solver.setup(torch.Generator().manual_seed(0))
    return solver


def _regions(prof) -> list[tuple[str, str | None]]:
    """(name, the nearest enclosing region's name or None) of each region
    of the port in the profiler's events."""
    out = []
    for e in prof.events():
        if not e.name.startswith("lrds."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("lrds."):
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name))
    return sorted(out, key=lambda r: (r[1] or "", r[0]))


EVAL = [("lrds.eval", None), ("lrds.eval.plan", "lrds.eval"),
        ("lrds.eval.prior", "lrds.eval"), ("lrds.eval.simulate", "lrds.eval")]
STEP = [("lrds.step", None), ("lrds.step.backward", "lrds.step"),
        ("lrds.step.ema", "lrds.step"), ("lrds.step.guard", "lrds.step"),
        ("lrds.step.loss", "lrds.step"), ("lrds.step.update", "lrds.step"),
        ("lrds.step.plan", "lrds.step.loss"), ("lrds.step.simulate", "lrds.step.loss")]


@pytest.mark.parametrize("case, loss_type, training, path, want", [
    ("evaluate", "lv", {}, "plain", EVAL + [("lrds.eval.results", "lrds.eval")]),
    ("evaluate", "lv", {"fused_eval": "off"}, "scan", EVAL),
    ("step", "lv", {}, "flat_lv_plain", STEP + [("lrds.step.ctrl_eval", "lrds.step.loss")]),
    ("step", "kl", {}, "kl_plain", STEP),
], ids=["eval_plain", "eval_scan", "step_flat_lv", "step_kl_plain"])
def test_regions_nest_as_documented(case, loss_type, training, path, want):
    solver = _solver(loss_type, **training)
    assert (solver.eval_path() if case == "evaluate" else solver.train_path()) == path
    g = torch.Generator().manual_seed(1)
    run = (lambda: solver.evaluate(g)) if case == "evaluate" else (lambda: solver.step(g))
    run()                                       # the same call unprofiled first
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert _regions(prof) == sorted(want, key=lambda r: (r[1] or "", r[0]))


def test_no_region_enters_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    solver = _solver()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    g = torch.Generator().manual_seed(1)
    solver.step(g)
    solver.evaluate(g)
    with annotate("lrds.eval"):
        pass
    with profile(activities=[ProfilerActivity.CPU]), pytest.raises(AssertionError):
        with annotate("lrds.eval"):
            pass


def test_a_pass_reads_the_host_seven_times():
    """compute_results at max_rnd 1e8 with the weights: the ELBO, whether
    any trajectory is kept, the filtered ELBO, the filtered share, the
    filtered and the plain log Z, the LV loss. No seed read on the CPU (the
    plain version draws its noise from the generator)."""
    solver = _solver()
    assert solver.loss.max_rnd == 1e8 and solver.eval_path() == "plain"
    before = host_read.count
    solver.evaluate(torch.Generator().manual_seed(1))
    assert host_read.count - before == 7


@pytest.mark.parametrize("training, reads", [
    ({}, 1),                                # the guard's
    ({"grad_clip": 1e-12}, 2),              # and the clip's norm, clipped
    ({"grad_clip": 1e12}, 2),               # and the clip's norm, not clipped
    ({"max_loss": 0.0}, 1),                 # a skipped step reads the guard only
])
def test_a_step_reads_the_host_as_documented(training, reads):
    solver = _solver(**training)
    before, skipped = host_read.count, solver.n_skipped
    solver.step(torch.Generator().manual_seed(1))
    assert host_read.count - before == reads
    assert solver.n_skipped - skipped == (1 if "max_loss" in training else 0)


@pytest.mark.parametrize("value", [torch.tensor(True), torch.tensor([7], dtype=torch.int64),
                                   torch.tensor(0.1, dtype=torch.float32),
                                   torch.tensor(0.1, dtype=torch.float64)],
                         ids=["bool", "int64", "float32", "float64"])
def test_host_read_returns_the_number_and_counts(value):
    before = profiling.host_read.count
    got = host_read(value)
    assert type(got) is type(value.item()) and got == value.item()
    assert profiling.host_read.count == before + 1
