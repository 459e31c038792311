"""The port's documentation site (``ccvm_tpu_torch/tools/build_docs.py``)
against the JAX package's (``tools/build_docs.py``, loaded by path and left
as it is) (CPU).

The site is built once, in a child process run as ``python -m`` runs the
tool, into a temporary directory.  Every module of the port that defines a
public class or function has a page; the guide pages are the README's port
section, ``PERF.md``, ``ROADMAP.md`` and the differences page, and none
names a TPU; both diagrams are drawn.  A module that fails to import, or a
missing guide source, stops the build.  The parity test reads the names on
each JAX API page and on its twin's page (inherited lines included), with
each shared callable's parameter names and plain defaults, and holds their
differences equal to the tool's table, in both directions.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest

from ccvm_tpu_torch.tools import build_docs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACADES = {"solvers.dl": "DLSolver", "solvers.mf": "MFSolver",
           "solvers.langevin": "LangevinSolver",
           "solvers.pumped_langevin": "PumpedLangevinSolver"}


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    """The site as ``python -m ccvm_tpu_torch.tools.build_docs --out DIR``
    builds it; the child then fails if it holds jax or the JAX package."""
    out = tmp_path_factory.mktemp("docs") / "torch_html"
    code = ("import runpy, sys;"
            "sys.argv = ['build_docs', '--out', sys.argv[1]];"
            "runpy.run_module('ccvm_tpu_torch.tools.build_docs', run_name='__main__');"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ccvm_tpu')];"
            "print('foreign modules:', bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code, str(out)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "foreign modules: []" in res.stdout
    return out


def _defines_public_members(mod):
    return any(not name.startswith("_") and getattr(obj, "__module__", None) == mod.__name__
               and (inspect.isclass(obj) or inspect.isfunction(obj))
               for name, obj in vars(mod).items())


def test_every_module_with_a_public_class_or_function_has_a_page(site):
    import ccvm_tpu_torch

    names = [info.name for info in pkgutil.walk_packages(ccvm_tpu_torch.__path__,
                                                         "ccvm_tpu_torch.")]
    expected = {"ccvm_tpu_torch"} | {
        n for n in names if _defines_public_members(importlib.import_module(n))}
    assert {"ccvm_tpu_torch.solvers.dl", "ccvm_tpu_torch.native",
            "ccvm_tpu_torch.ops.build", "ccvm_tpu_torch.tools.build_docs"} <= expected
    pages = {f[len("api_"):-len(".html")] for f in os.listdir(site) if f.startswith("api_")}
    assert pages == {n.replace(".", "_") for n in expected}


@pytest.mark.parametrize("module", sorted(build_docs.REPLACES))
def test_kernel_wrapper_pages_name_the_tpu_kernels_they_replace(site, module):
    """Each ops/*_kernels.py page names its template and the Pallas kernels
    it replaces, at lines that define them."""
    source, kernels = build_docs.REPLACES[module]
    assert os.path.isfile(os.path.join(REPO, "ccvm_tpu_torch", source))
    page = (site / f"api_ccvm_tpu_torch_{module.replace('.', '_')}.html").read_text()
    assert source in page
    for kernel, where in kernels:
        path, line = where.rsplit(":", 1)
        with open(os.path.join(REPO, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith(f"def {kernel}(")
        assert f"<code>{kernel}</code> (<code>{where}</code>)" in page


def test_guide_pages_are_the_port_section_perf_and_roadmap(site):
    assert [(rel, section) for _, rel, _, section in build_docs.PAGES] == [
        ("README.md", build_docs.README_SECTION), ("PERF.md", None), ("ROADMAP.md", None)]
    with open(os.path.join(REPO, "README.md")) as f:
        readme = f.read()
    sources = build_docs.guide_sources()
    assert sources["index"] == readme[readme.index(build_docs.README_SECTION + "\n"):]
    for slug, rel in (("perf", "PERF.md"), ("roadmap", "ROADMAP.md")):
        with open(os.path.join(REPO, rel)) as f:
            assert sources[slug] == f.read()
    others = {f for f in os.listdir(site) if f.endswith(".html") and not f.startswith("api_")}
    assert others == {"index.html", "perf.html", "roadmap.html", "differences.html",
                      "diagrams.html"}
    index = (site / "index.html").read_text()
    assert "docs/equations_of_motion.md" in index and "docs/solvers/*.md" in index
    assert "The PyTorch/CUDA port" in index and "Why it&#x27;s fast on TPU" not in index
    for page in site.glob("*.html"):
        text = page.read_text()
        assert "v5e" not in text and "TPU v" not in text, page.name


def test_cut_section_stops_at_the_next_heading_outside_code():
    text = "# a\n## b\nx\n```\n## not a heading\n```\n### c\ny\n## d\nz\n"
    assert build_docs.cut_section(text, "## b") == (
        "## b\nx\n```\n## not a heading\n```\n### c\ny\n")
    assert build_docs.cut_section(text, "## d") == "## d\nz\n"
    with pytest.raises(ValueError, match="## e"):
        build_docs.cut_section(text, "## e")


def test_both_diagrams_are_drawn(site):
    for name in ("architecture.png", "solver_hierarchy.png"):
        data = (site / "diagrams" / name).read_bytes()
        assert len(data) > 10_000 and data[:8] == b"\x89PNG\r\n\x1a\n", name
        assert f'src="diagrams/{name}"' in (site / "diagrams.html").read_text()


def _broken(tmp_path, path, monkeypatch):
    target = tmp_path / path
    target.parent.mkdir(parents=True, exist_ok=True)
    for parent in target.relative_to(tmp_path).parents:
        if str(parent) != ".":
            (tmp_path / parent / "__init__.py").touch()
    target.write_text("raise RuntimeError('broken on purpose')\n")
    monkeypatch.syspath_prepend(str(tmp_path))


@pytest.mark.parametrize("case", ["module", "package"])
def test_a_module_that_fails_to_import_stops_the_build(monkeypatch, tmp_path, capsys,
                                                       case):
    """A module the walk meets (injected into the walk) or a package the
    walk itself imports raises ImportError naming it; nothing is written and
    nothing is skipped."""
    if case == "module":
        _broken(tmp_path, "docs_walk_extra.py", monkeypatch)
        walk = build_docs.walk_modules
        monkeypatch.setattr(build_docs, "walk_modules", lambda: walk() + ["docs_walk_extra"])
        name = "docs_walk_extra"
    else:
        _broken(tmp_path, os.path.join("docs_walk_pkg", "broken", "__init__.py"), monkeypatch)
        monkeypatch.setattr(build_docs, "PACKAGE", "docs_walk_pkg")
        name = "docs_walk_pkg.broken"
    out = tmp_path / "out"
    with pytest.raises(ImportError, match=re.escape(name) + ".*broken on purpose") as err:
        build_docs.main(["--out", str(out)])
    assert err.value.name == name
    assert not out.exists()
    assert "skip" not in capsys.readouterr().out


def test_the_command_exits_non_zero_on_a_module_that_fails_to_import(tmp_path):
    (tmp_path / "docs_walk_extra.py").write_text("raise RuntimeError('broken on purpose')\n")
    code = ("import sys; from ccvm_tpu_torch.tools import build_docs as b;"
            "walk = b.walk_modules; b.walk_modules = lambda: walk() + ['docs_walk_extra'];"
            "b.main(['--out', sys.argv[1]])")
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "out")], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, str(tmp_path)])),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "ImportError: cannot document docs_walk_extra" in res.stderr, res.stderr
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("missing", ["README.md", "PERF.md", "ROADMAP.md"])
def test_a_missing_guide_source_raises(monkeypatch, tmp_path, missing):
    for rel in ("README.md", "PERF.md", "ROADMAP.md"):
        if rel != missing:
            shutil.copy(os.path.join(REPO, rel), tmp_path / rel)
    monkeypatch.setattr(build_docs, "REPO", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        build_docs.main(["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_a_readme_without_the_port_section_raises(monkeypatch, tmp_path):
    for rel in ("PERF.md", "ROADMAP.md"):
        shutil.copy(os.path.join(REPO, rel), tmp_path / rel)
    (tmp_path / "README.md").write_text("# tpu-ccvm\n\n## Quick start\n")
    monkeypatch.setattr(build_docs, "REPO", str(tmp_path))
    with pytest.raises(ValueError, match=re.escape(build_docs.README_SECTION)):
        build_docs.guide_sources()


# ---- parity with the JAX package's API pages ---------------------------

_ENTRY = re.compile(
    r'<h2 id="(?P<top>[^"]+)">(?P<cls>class )?'
    r'|<div class="member">\s*<div class="api-sig">(?:property )?(?P<own>\w+)'
    r'|<div class="member inherited"><code>(?:property )?(?P<inh>\w+)[^<]*</code>: '
    r'inherited from <a href="[^"]*"><code>(?P<base>\w+)</code></a>')
_PLAIN = (str, int, float, bool, type(None))


def _page_names(body):
    """{name: the base class it is inherited from, or None} of the classes,
    functions and class members ("Class.member") on an API page."""
    names, current = {}, None
    for m in _ENTRY.finditer(body):
        if m["top"]:
            current = m["top"] if m["cls"] else None
            names[m["top"]] = None
        elif m["own"]:
            names[f"{current}.{m['own']}"] = None
        else:
            names[f"{current}.{m['inh']}"] = m["base"]
    return names


def _resolve(mod, name):
    obj = mod
    for part in name.split("."):
        obj = inspect.getattr_static(obj, part) if inspect.isclass(obj) else getattr(obj, part)
    return obj.__func__ if isinstance(obj, staticmethod) else obj


def _parameters(obj):
    try:
        return inspect.signature(obj).parameters
    except (TypeError, ValueError):
        return {}


def _inherited(cls, member):
    return next(b for b in cls.__mro__ if member in vars(b)) is not cls


@pytest.fixture(scope="module")
def jax_tool():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    spec = importlib.util.spec_from_file_location(
        "jax_build_docs", os.path.join(REPO, "tools", "build_docs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twins(jax_tool):
    """(name relative to either package, JAX module, port module) of each
    of the JAX tool's API modules but ops.pallas_kernels, whose kernels the
    four ops/*_kernels.py modules wrap."""
    twins = []
    for jax_name in jax_tool.API_MODULES:
        rel = jax_name.partition(".")[2]
        if rel == "ops.pallas_kernels":
            continue
        port_name = "ccvm_tpu_torch" + (f".{rel}" if rel else "")
        twins.append((rel, jax_name, port_name))
    return twins


def test_api_pages_differ_from_the_jax_pages_exactly_as_the_table_says(site, jax_tool):
    found, expected = set(), set()
    for rel, jax_name, port_name in _twins(jax_tool):
        jax_mod, port_mod = (importlib.import_module(n) for n in (jax_name, port_name))
        jax_names = _page_names(jax_tool._api_page_body(jax_name))
        port_names = _page_names((site / f"api_{port_name.replace('.', '_')}.html").read_text())
        for name in jax_names:
            if name not in port_names:
                found.add((rel, name, "absent", ()))
                continue
            if "." in name:
                cls, member = name.split(".")
                if _inherited(getattr(jax_mod, cls), member) != (port_names[name] is not None):
                    found.add((rel, name, "inherited", port_names[name] or ""))
            jax_params = _parameters(_resolve(jax_mod, name))
            port_params = _parameters(_resolve(port_mod, name))
            if list(jax_params) != list(port_params):
                found.add((rel, name, "parameters", (tuple(jax_params), tuple(port_params))))
            for p in set(jax_params) & set(port_params):
                a, b = jax_params[p].default, port_params[p].default
                if isinstance(a, _PLAIN) and isinstance(b, _PLAIN) and a != b:
                    found.add((rel, name, "default", (p, b)))
    for d in build_docs.DIFFERENCES:
        jax_mod = importlib.import_module("ccvm_tpu." + d.module)
        for name in d.names:
            if d.kind == "parameters":
                before = tuple(_parameters(_resolve(jax_mod, name)))
                renamed = dict(d.renamed)
                after = tuple(renamed.get(p, p) for p in before
                              if p not in d.removed) + d.added
                expected.add((d.module, name, d.kind, (before, after)))
            else:
                detail = {"absent": (), "inherited": d.base, "default": d.default}[d.kind]
                expected.add((d.module, name, d.kind, detail))
    assert not found - expected, f"differences missing from the table: {sorted(found - expected)}"
    assert not expected - found, f"table rows that no longer hold: {sorted(expected - found)}"


def test_every_facade_page_shows_tune_as_inherited_from_ccvm_solver(site):
    for module, cls in FACADES.items():
        page = (site / f"api_ccvm_tpu_torch_{module.replace('.', '_')}.html").read_text()
        assert _page_names(page)[f"{cls}.tune"] == "CCVMSolver", module
        assert 'href="api_ccvm_tpu_torch_solvers_base.html#CCVMSolver"' in page


def test_problem_instance_defaults_to_the_card():
    from ccvm_tpu.problem_classes.boxqp.problem_instance import ProblemInstance as JaxInstance

    from ccvm_tpu_torch import ProblemInstance

    assert inspect.signature(ProblemInstance).parameters["device"].default == "cuda"
    assert inspect.signature(JaxInstance).parameters["device"].default == "cpu"
