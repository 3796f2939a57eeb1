"""The port stands alone: `repro_torch`, `chip_smoke.py` and
`tools/torch_trace_lint.py` import neither JAX nor the reference package
`repro`, and importing the port builds no kernel (no nvcc, no CUDA
needed)."""

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
        for mod in ("coded_combine", "flash_attention", "rglru_scan", "ssd_scan"):
            lib = sys.modules["repro_torch.kernels." + mod]._lib
            assert lib.cache_info().currsize == 0, mod
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
