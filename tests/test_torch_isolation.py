"""The port stands alone: no module of byzantinerandomizedconsensus_tpu_torch,
and not chip_smoke.py, imports JAX or the reference package."""

import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "byzantinerandomizedconsensus_tpu_torch"
FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|byzantinerandomizedconsensus_tpu)(?:[.\s,]|$)",
    re.MULTILINE)


def test_no_source_of_the_port_imports_jax_or_the_reference():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 10
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in sources for m in FORBIDDEN.finditer(p.read_text())]
    assert offenders == []


def test_port_imports_and_runs_with_jax_and_the_reference_blocked():
    """Every module of the port imports, and the CLI runs config4 on the
    CPU, in a process where importing jax or the reference package fails."""
    code = textwrap.dedent("""
        import importlib, importlib.abc, json, pkgutil, sys

        BLOCKED = ("jax", "jaxlib", "byzantinerandomizedconsensus_tpu")

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Block())
        import byzantinerandomizedconsensus_tpu_torch as port
        names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        from byzantinerandomizedconsensus_tpu_torch import cli
        cli.main(["run", "--preset", "config4", "--instances", "3", "--device", "cpu"])
        assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
        print(json.dumps(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert '"decision_histogram"' in lines[0]
    assert "byzantinerandomizedconsensus_tpu_torch.ops.fused_round" in lines[-1]
