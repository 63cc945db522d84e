"""In a fresh process: importing every module of the benchmark loads no
module whose top-level name, taken whole, is jax, jaxlib or
reduced_3dgs_tpu; importing the reference loads nothing of the program
either; and a tiny run leaves none of them loaded."""
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "reduced_3dgs_tpu"]


def loaded_after(code: str) -> set:
    probe = (f"import sys, json\nsys.path.insert(0, {str(ROOT)!r})\n{code}\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_imports_without_jax():
    files = sorted((ROOT / "gpubench").rglob("*.py"))
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts) for p in files
               if "tests" not in p.parts and "metrics" not in p.parts]
    readers = [str(p) for p in files if "metrics" in p.parts]
    code = ("import importlib, importlib.util\n"
            f"for m in {modules!r}:\n    importlib.import_module(m)\n"
            f"for i, p in enumerate({readers!r}):\n"
            "    s = importlib.util.spec_from_file_location(f'r{i}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n")
    assert not loaded_after(code) & set(FORBIDDEN)
    assert len(modules) >= 10 and readers


def test_reference_imports_nothing_of_the_program():
    loaded = loaded_after("import gpubench.reference.render, gpubench.reference.train")
    assert not loaded & set(FORBIDDEN + ["reduced_3dgs_torch"])


def test_a_run_loads_no_jax():
    code = ("sys.path.insert(0, " + repr(str(ROOT / "gpubench" / "tests")) + ")\n"
            "from conftest import tiny_run\ntiny_run('truck-flagship.render')\n")
    loaded = loaded_after(code)
    assert "reduced_3dgs_torch" in loaded and not loaded & set(FORBIDDEN)
