"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax``, ``jaxlib`` or anything of the JAX
package ``repro`` — not even its JAX-free modules.  Checked in a fresh
interpreter whose import system refuses those names."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "repro")

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print(len(names), "modules")
    print("\\n".join(names))
""")


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    mods = set(res.stdout.split())
    for m in ("repro_torch.core.milp", "repro_torch.models.stage",
              "repro_torch.serving.runtime", "repro_torch.launch.serve",
              "repro_torch.kernels.paged_attention.kernel",
              "repro_torch.kernels.flash_attention.kernel",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.serving.engine",
              "repro_torch.serving.stage_engine",
              "repro_torch.convert"):
        assert m in mods, res.stdout


def test_no_source_mentions_jax_imports():
    """A static check beside the dynamic one: no import line of the port
    names jax or the reference package."""
    offenders = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            for i, line in enumerate(open(path), 1):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    if mod.split(".")[0] in ("jax", "jaxlib", "repro"):
                        offenders.append(f"{path}:{i}: {s}")
    assert not offenders, offenders
