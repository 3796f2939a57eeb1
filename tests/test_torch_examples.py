"""The example twins (`examples/torch_*.py`) on the CPU, held to their
originals (`examples/quickstart.py`, `decentralized_lstsq.py`,
`coded_lm_training.py`) on `repro`.

Each twin prints the same lines as its original. Here a twin runs with
``--device cpu`` in float32 and its printed numbers are held to the
original's printed numbers, line by line (the same text; each number
within two units of its last printed digit: float32 against the
reference's x64 run of this suite):

- the quickstart at full size, against the original script run whole;
- the §V reproduction at ``--iters 200`` against the same lines from
  `repro`'s functions at 200 iterations (the original fixes 1200);
- the LM example at smoke size (12 steps of 16 rows of 16 tokens) from
  the original's initial weights, against the original's ``main``.

The twins import neither JAX nor `repro`.
"""

import contextlib
import dataclasses
import io
import pathlib
import re
import runpy

import jax
import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("torch_quickstart.py", "torch_decentralized_lstsq.py", "torch_coded_lm_training.py")
NUMBER = re.compile(r"-?\d+(?:\.(\d+))?(?:e([+-]\d+))?")
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def _load(name):
    """An example file as a module (its ``main`` not run)."""
    return runpy.run_path(str(EXAMPLES / name), run_name="example")


def _printed(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return out.getvalue(), result


def _same_lines(got: str, want: str) -> None:
    """Line by line the same text, each number within two units of its
    last printed digit."""
    got_lines, want_lines = got.strip().splitlines(), want.strip().splitlines()
    assert len(got_lines) == len(want_lines), (got, want)
    for g, w in zip(got_lines, want_lines):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for mg, mw in zip(NUMBER.finditer(g), NUMBER.finditer(w)):
            unit = 10.0 ** -len(mw.group(1) or "") * 10.0 ** int(mw.group(2) or 0)
            assert abs(float(mg.group(0)) - float(mw.group(0))) <= 2 * unit, (g, w)


def test_twins_import_neither_jax_nor_repro():
    for name in TWINS:
        assert not FORBIDDEN.search((EXAMPLES / name).read_text()), name


def test_quickstart_twin_prints_the_originals_lines():
    twin = _load("torch_quickstart.py")
    got, _ = _printed(twin["main"], ["--device", "cpu"])
    want, _ = _printed(runpy.run_path, str(EXAMPLES / "quickstart.py"))
    _same_lines(got, want)
    assert got.strip().endswith("OK — csI-ADMM converged under random stragglers.")


def _lstsq_reference_lines(iters: int) -> str:
    """What `examples/decentralized_lstsq.py` prints, at ``iters``
    iterations, from `repro`'s functions."""
    from repro.core.admm import ADMMConfig, run_incremental_admm
    from repro.core.baselines import run_dadmm, run_dgd, run_extra, run_wadmm
    from repro.core.graph import make_network
    from repro.core.problems import DATASETS, allocate
    from repro.core.timing import StragglerModel

    N, K, TARGET = 10, 3, 0.15
    net = make_network(N, connectivity=0.5, seed=0)
    problem = allocate(DATASETS["usps"](0), N, K)

    def comm_to(trace, target):
        hit = np.nonzero(trace.accuracy <= target)[0]
        return trace.comm_cost[hit[0]] if len(hit) else float("inf")

    lines = []
    cfg = ADMMConfig(M=60, K=K, S=0, scheme="uncoded", rho=1.0, c_tau=0.5, c_gamma=1.0)
    traces = {
        "sI-ADMM": run_incremental_admm(problem, net, cfg, iters),
        "W-ADMM": run_wadmm(problem, net, cfg, iters),
        "D-ADMM": run_dadmm(problem, net, 0.1, iters // 10),
        "DGD": run_dgd(problem, net, 0.05, iters // 10),
        "EXTRA": run_extra(problem, net, 0.05, iters // 10),
    }
    lines.append(f"{'method':10s} {'comm to acc<=' + str(TARGET):>16s} {'final acc':>10s}")
    for name, tr in traces.items():
        lines.append(f"{name:10s} {comm_to(tr, TARGET):16.0f} {tr.accuracy[-1]:10.4f}")
    lines.append("\nmini-batch sweep (uncoded sI-ADMM):")
    for M in (6, 30, 90):
        cfg = ADMMConfig(M=M, K=K, S=0, scheme="uncoded", rho=1.0, c_tau=0.5, c_gamma=1.0)
        tr = run_incremental_admm(problem, net, cfg, iters)
        lines.append(f"  M={M:3d}: final accuracy {tr.accuracy[-1]:.4f}")
    lines.append("\nstraggler running time (30% straggle prob, delay cap sweep):")
    rows = {}
    for eps in (2e-3, 1e-2):
        strag = StragglerModel(p_straggle=0.3, delay=5e-3, epsilon=eps)
        for label, scheme, S in (("uncoded", "uncoded", 0), ("csI-ADMM", "cyclic", 1)):
            cfg = ADMMConfig(M=60, K=K, S=S, scheme=scheme, rho=1.0, c_tau=0.5, c_gamma=1.0)
            tr = run_incremental_admm(problem, net, cfg, iters, straggler=strag)
            rows[(label, eps)] = tr.sim_time[-1]
            lines.append(f"  {label:9s} eps={eps:.0e}: {tr.sim_time[-1]:6.2f}s "
                         f"(acc {tr.accuracy[-1]:.4f})")
    uncoded = rows[("uncoded", 1e-2)] / rows[("uncoded", 2e-3)]
    coded = rows[("csI-ADMM", 1e-2)] / rows[("csI-ADMM", 2e-3)]
    lines.append(f"\nrunning-time growth with 5x delay cap: "
                 f"uncoded {uncoded:.2f}x vs coded {coded:.2f}x")
    lines.append("OK — all three §V claims reproduced.")
    return "\n".join(lines)


def test_decentralized_lstsq_twin_prints_the_originals_lines():
    twin = _load("torch_decentralized_lstsq.py")
    got, out = _printed(twin["main"], ["--device", "cpu", "--iters", "200"])
    _same_lines(got, _lstsq_reference_lines(200))
    assert set(out["traces"]) == {"sI-ADMM", "W-ADMM", "D-ADMM", "DGD", "EXTRA"}


def test_coded_lm_training_twin_prints_the_originals_lines():
    """Both from the original's initial weights (``model.init`` at key 0,
    carried over by `from_reference`)."""
    from repro.models import ModelConfig as RModelConfig
    from repro.models import get_model as r_get_model
    from repro_torch.models import ModelConfig, from_reference

    argv = ["--steps", "12", "--seq", "16", "--batch-rows", "1", "--log-every", "1"]
    original, twin = _load("coded_lm_training.py"), _load("torch_coded_lm_training.py")
    want, want_losses = _printed(original["main"], argv)
    args = twin["parse_args"](argv + ["--device", "cpu"])
    s = original["SIZES"][args.params]
    assert s == twin["SIZES"][args.params]
    cfg_r = RModelConfig(name=f"consensus-lm-{args.params}", family="dense",
                         head_dim=s["d_model"] // s["n_heads"], qk_norm=True,
                         dtype="float32", **s)
    params = jax.tree.map(np.asarray, r_get_model(cfg_r).init(jax.random.key(0)))
    model = from_reference(ModelConfig.from_dict(dataclasses.asdict(cfg_r)), params, "cpu")
    # The twin's config, but for which route runs attention (on the CPU
    # both run the plain version).
    cfg_t = twin["model_config"](args.params)
    assert dataclasses.replace(model.cfg, attn_impl=cfg_t.attn_impl,
                               ssm_impl=cfg_t.ssm_impl) == cfg_t
    model.cfg = cfg_t
    got, losses = _printed(twin["train"], model, args)
    _same_lines(got, want)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=0)
