"""The port stands alone: `repro_torch`, `chip_smoke.py` and
`tools/torch_trace_lint.py` import neither JAX nor the reference package
`repro`, and importing the port builds no kernel (no nvcc, no CUDA
needed). Its kernels layer depends on nothing above it."""

import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = textwrap.dedent(
        """
        import importlib, importlib.util, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        # The trace-lint CLI twin, AST lint and step audit, on the CPU.
        spec = importlib.util.spec_from_file_location(
            "torch_trace_lint", "tools/torch_trace_lint.py")
        cli = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cli)
        assert cli.main(["--device", "cpu"]) == 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        assert not bad, bad
        # importing loads (and builds) no kernel
        from repro_torch.kernels._build import Library
        libs = [v for m in list(sys.modules.values()) for v in vars(m).values()
                if isinstance(v, Library)]
        assert sorted(lib.name for lib in libs) == sorted(
            ["causal_conv", "coded_combine", "flash_attention", "rglru_scan", "ssd_scan"])
        assert not [lib.name for lib in libs if lib.fns], libs
        for mod in ("models.transformer", "models.rglru", "models.params",
                    "configs.qwen3_0_6b", "configs.recurrentgemma_9b",
                    "launch.serve", "models.mamba2", "models.losses",
                    "kernels.ssd_scan", "configs.mamba2_1_3b", "optim.sgd",
                    "optim.schedules", "data.lm", "checkpoint.npz",
                    "distributed.plain", "launch.train", "data.lsq",
                    "methods.walkman", "methods.gossip", "methods.privacy",
                    "methods.compression", "core.baselines",
                    "methods.reductions", "control.bandit", "control.kernel",
                    "distributed.consensus", "configs.phi35_moe",
                    "configs.mixtral_8x22b", "configs.qwen2_vl_72b",
                    "configs.llama3_405b", "configs.stablelm_1_6b",
                    "configs.internlm2_20b", "models.whisper",
                    "configs.whisper_medium", "analysis.astcheck",
                    "analysis.traceaudit"):
            assert "repro_torch." + mod in names, mod
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # Every module imported: one per source file but the package's own
    # __init__.
    assert int(out.stdout.split()[-1]) == len(list(PKG.rglob("*.py"))) - 1
    assert "10 grids / 15 static groups clean on cpu" in out.stdout


def test_sources_never_import_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "torch_trace_lint.py"
    ]
    assert len(files) > 20
    offenders = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in files
        for m in FORBIDDEN.finditer(p.read_text())
    ]
    assert not offenders, offenders
    # The pattern itself: the port's own imports pass, the reference's do not.
    assert not FORBIDDEN.search("from repro_torch.core import coding")
    assert FORBIDDEN.search("from repro.core import coding")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("    import repro\n")


def test_kernels_import_nothing_of_the_models():
    """No module under `repro_torch/kernels` imports `repro_torch.models`
    (absolutely or relatively, at module level or inside a function): the
    plain forms a kernel is held to or differentiates live in
    `kernels/ref.py`, so an edit to a model cannot move a kernel's twin."""
    files = sorted((PKG / "kernels").glob("*.py"))
    assert len(files) >= 8
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # in kernels/x.py, level 1 is repro_torch.kernels, level 2 repro_torch
                pkg = ["", "repro_torch.kernels", "repro_torch"][node.level]
                mod = ".".join(p for p in (pkg, node.module) if p)
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if n.split(".")[:2] == ["repro_torch", "models"]]
    assert not offenders, offenders
