"""The port's notebooks (the twins of ``tutorial.ipynb`` and
``testing.ipynb`` on ``shadowing_tpu_torch``) must parse, import neither JAX
nor the JAX package, and execute end to end at the reduced sizes of
``tests/test_notebooks.py`` with ``DEVICE = "cpu"``."""
import json
import re
from pathlib import Path

import pytest
from test_notebooks import _SHRINK, _cells

NB_DIR = Path(__file__).parents[1] / "notebooks"
NAMES = ["tutorial", "testing"]
#: the twins run on the card unless told otherwise; the tests say "cpu"
_DEVICE = (r'DEVICE = "cuda"', 'DEVICE = "cpu"')


@pytest.mark.parametrize("name", NAMES)
def test_twin_parses_cell_for_cell(name):
    twin = _cells(NB_DIR / f"{name}_torch.ipynb")
    assert len(twin) == len(_cells(NB_DIR / f"{name}.ipynb"))
    assert twin[0].count(_DEVICE[0]) == 1
    for i, src in enumerate(twin):
        compile(src, f"{name}_torch[{i}]", "exec")
        assert not re.search(r"^\s*(import|from)\s+(jax|shadowing_tpu)(\.|\s|$)",
                             src, re.M), f"cell {i} imports the JAX side"


@pytest.mark.parametrize("name", NAMES)
def test_twin_commits_no_outputs(name):
    nb = json.loads((NB_DIR / f"{name}_torch.ipynb").read_text())
    for c in nb["cells"]:
        if c["cell_type"] == "code":
            assert c["outputs"] == [] and c["execution_count"] is None


@pytest.mark.parametrize("name", NAMES)
def test_twin_executes_shrunk_on_the_cpu(name, tmp_path, monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    monkeypatch.chdir(tmp_path)  # the caches under cwd/_cache stay in tmp

    env = {"__name__": "__main__"}
    for i, src in enumerate(_cells(NB_DIR / f"{name}_torch.ipynb")):
        for pat, rep in [*_SHRINK, _DEVICE]:
            src = re.sub(pat, rep, src)
        try:
            exec(compile(src, f"{name}_torch[{i}]", "exec"), env)
        except Exception as e:  # pragma: no cover
            raise AssertionError(
                f"{name}_torch.ipynb code cell {i} failed: {e}\n--- cell ---\n"
                f"{src}") from e
    assert env["DEVICE"] == "cpu"
    # every cache the walkthrough wrote sits under a *_torch directory
    cached = [p for p in (tmp_path / "_cache").rglob("*") if p.is_file()] \
        if (tmp_path / "_cache").exists() else []
    assert all(any(part.endswith("_torch") for part in p.parts)
               for p in cached)
    import matplotlib.pyplot as plt

    plt.close("all")
