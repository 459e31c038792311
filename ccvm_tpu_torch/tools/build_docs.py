"""Build the HTML documentation site of ccvm_tpu_torch: the twin of
``tools/build_docs.py``, with its three deliverables for the port.

  * guide pages: the README's section on the port, ``PERF.md`` and
    ``ROADMAP.md`` (markdown-it, pygments highlighting), and a generated
    page of the port's differences of surface from the JAX package
    (:data:`DIFFERENCES`);
  * an API reference generated with ``inspect``: one page for the package
    root and one for every module under it that defines a public class or
    function, found by walking the package (``pkgutil``), each page in
    source order, with the methods a class inherits from another class of
    the package as lines that link to that class;
  * the port's layer map and solver hierarchy (matplotlib).

It is host-only: it needs markdown-it, pygments and matplotlib, and no
``nvcc`` and no card (importing a module of the port builds nothing).
Nothing falls back: a guide source that is missing, or a module that fails
to import, raises and the build stops.  The maths, which both packages
share, stays in ``docs/equations_of_motion.md`` and ``docs/solvers/*.md``;
those pages are not rendered here.

Usage:  python -m ccvm_tpu_torch.tools.build_docs [--out DIR]   (or ``make docs-torch``)
Output: docs/_build/torch_html/index.html
"""

from __future__ import annotations

import argparse
import dataclasses
import html
import importlib
import inspect
import os
import pkgutil
import shutil
import sys

PACKAGE = "ccvm_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(REPO, "docs", "_build", "torch_html")

# (slug, source file, title, the heading of the section to cut out, or None
# for the whole file).
README_SECTION = "## The PyTorch/CUDA port: `ccvm_tpu_torch`"
PAGES = [
    ("index", "README.md", "Overview", README_SECTION),
    ("perf", "PERF.md", "Performance on the H100", None),
    ("roadmap", "ROADMAP.md", "Roadmap", None),
]
DIFFERENCES_PAGE = ("differences", "Differences from ccvm_tpu")

PREFACE = (
    "<p>This site documents <code>ccvm_tpu_torch</code>, the port of the JAX "
    "package to PyTorch and hand-written CUDA kernels for the NVIDIA H100. The "
    "maths, which both packages share, is set out in "
    "<code>docs/equations_of_motion.md</code> and <code>docs/solvers/*.md</code> "
    "of the repository.</p>")


@dataclasses.dataclass(frozen=True)
class Difference:
    """One difference of the port's public surface from the JAX package's:
    names of ``module`` (relative to either package) that the JAX package's
    API page lists and that the port leaves out (``kind`` "absent"), takes
    with other parameters ("parameters": each JAX parameter renamed as
    ``renamed`` says, then ``added`` appended), inherits from its class
    ``base`` where the JAX class defines them ("inherited"), or takes with
    another default ("default": ``default`` is (parameter, the port's
    value))."""

    module: str
    names: tuple
    kind: str
    reason: str
    renamed: tuple = ()
    added: tuple = ()
    base: str = ""
    default: tuple = ()

    @property
    def text(self):
        """The difference in words, for the table."""
        if self.kind == "absent":
            return "absent from the port"
        if self.kind == "inherited":
            return f"inherited from <code>{self.base}</code>"
        if self.kind == "default":
            parameter, value = self.default
            return f"<code>{parameter}</code> defaults to <code>{value!r}</code>"
        parts = [f"<code>{old}</code> becomes <code>{new}</code>" for old, new in self.renamed]
        if self.added:
            parts.append("the port adds " + " and ".join(f"<code>{a}</code>" for a in self.added))
        return "; ".join(parts)


_NOISE_KEY = ("The port's noise is one Philox4x32-10 stream keyed by an integer seed "
              "(instance i of a sweep draws with seed + i), not a JAX PRNG key.")
_TUNER = ("The port defines the tuner once, on the base class (tuning.tune_solver); "
          "the JAX base class declares an abstract tune() that each façade overrides.")
_CARD = ("The port runs on the card unless the caller asks for the CPU, and "
         "nothing falls back from one to the other.")

DIFFERENCES = [
    Difference("dynamics.common", ("normal", "scan_steps", "scan_steps_from",
                                   "scan_steps_segmented"), "absent",
               "JAX-only machinery: the JAX solves integrate with lax.scan and draw "
               "with jax.random. The port's plain versions loop over steps in "
               "PyTorch, its kernels run a whole solve in one launch, and both draw "
               "from ops/philox.py."),
    Difference("dynamics.common", ("tp_matvec",), "parameters",
               "A torch.distributed collective runs over a process group (a mesh's "
               '"model" axis), not over a named axis of shard_map.',
               renamed=(("axis_name", "group"),)),
    Difference("parallel.tp", ("dl_sharded_solve", "dl_solve", "mf_solve",
                               "langevin_solve", "pumped_langevin_solve"), "parameters",
               _NOISE_KEY + " noise_scale (0 turns the noise off) and rng (the Wiener "
               "transform) are the kernels' own arguments.",
               renamed=(("key", "seed"),), added=("noise_scale", "rng")),
    Difference("parallel.multihost", ("initialize",), "parameters",
               '"cuda" joins an NCCL group and takes the card of the local rank, '
               '"cpu" a gloo group; JAX\'s distributed runtime chooses its own.',
               added=("device",)),
    Difference("checkpoint", ("checkpointed_solve",), "parameters", _NOISE_KEY,
               renamed=(("key", "seed"),)),
    Difference("runtime", ("enable_compilation_cache",), "absent",
               "It turns on XLA's persistent compilation cache. The port's kernels "
               "are built by ops/build.py with nvcc at first use into build/kernels, "
               "one library a specialisation, named by a hash of its sources: that "
               "is their cache."),
    Difference("profiling", ("Timer", "Timer.__call__", "solve_rate"), "absent",
               "Solution.solve_time is Timer's per-trajectory span, and solve_rate "
               "divided one solve's span, not a rate over a window. The port's own "
               "spans and counters (annotate, count, spans) record each layer of a "
               "call while a profiler runs."),
    Difference("solvers.base", ("CCVMSolver.tune",), "parameters", _TUNER,
               added=("instances", "post_processor", "parameter_ranges", "kwargs")),
    Difference("solvers.dl", ("DLSolver.tune",), "inherited", _TUNER, base="CCVMSolver"),
    Difference("solvers.mf", ("MFSolver.tune",), "inherited", _TUNER, base="CCVMSolver"),
    Difference("solvers.langevin", ("LangevinSolver.tune",), "inherited", _TUNER,
               base="CCVMSolver"),
    Difference("solvers.pumped_langevin", ("PumpedLangevinSolver.tune",), "inherited",
               _TUNER, base="CCVMSolver"),
    Difference("problem_classes.boxqp.problem_instance",
               ("ProblemInstance", "ProblemInstance.load_instance"), "default", _CARD,
               default=("device", "cuda")),
    Difference("solution", ("Solution",), "default", _CARD, default=("device", "cuda")),
]

# The TPU kernels that each wrapper module's CUDA template replaces.
REPLACES = {
    "ops.dl_kernels": ("csrc/dl_solve.cu", (
        ("_dl_kernel", "ccvm_tpu/ops/pallas_kernels.py:843"),
        ("_dl_adam_kernel", "ccvm_tpu/ops/pallas_kernels.py:977"))),
    "ops.mf_kernels": ("csrc/mf_solve.cu", (
        ("_mf_kernel", "ccvm_tpu/ops/pallas_kernels.py:1085"),
        ("_mf_adam_kernel", "ccvm_tpu/ops/pallas_kernels.py:1224"))),
    "ops.langevin_kernels": ("csrc/langevin_solve.cu", (
        ("_langevin_kernel", "ccvm_tpu/ops/pallas_kernels.py:488"),
        ("_langevin_adam_kernel", "ccvm_tpu/ops/pallas_kernels.py:585"),
        ("_pumped_langevin_kernel", "ccvm_tpu/ops/pallas_kernels.py:657"),
        ("_pumped_langevin_adam_kernel", "ccvm_tpu/ops/pallas_kernels.py:762"))),
    "ops.dl_variant_kernels": ("csrc/dl_variants.cu", (
        ("_dl_kernel_v2", "tools/kernel_experiments.py:91"),
        ("_dl_kernel_v3", "tools/kernel_experiments.py:201"))),
}

CSS = """
body { font-family: -apple-system, "Segoe UI", Roboto, sans-serif;
       margin: 0; color: #1a1a1a; line-height: 1.55; }
.layout { display: flex; min-height: 100vh; }
nav { width: 240px; background: #f6f7f9; border-right: 1px solid #e3e5e8;
      padding: 1.2rem .9rem; flex-shrink: 0; }
nav h2 { font-size: .8rem; text-transform: uppercase; letter-spacing: .06em;
         color: #667; margin: 1.1rem 0 .3rem; }
nav a { display: block; color: #234; text-decoration: none;
        padding: .15rem .4rem; border-radius: 4px; font-size: .92rem; }
nav a:hover { background: #e8ebf0; }
nav a.current { background: #dde3ee; font-weight: 600; }
main { flex: 1; max-width: 54rem; padding: 1.5rem 2.5rem 4rem; }
h1, h2, h3 { line-height: 1.25; }
code { background: #f2f3f5; padding: .1em .3em; border-radius: 3px;
       font-size: .9em; }
pre { background: #f6f8fa; border: 1px solid #e3e5e8; border-radius: 6px;
      padding: .8rem 1rem; overflow-x: auto; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1rem 0; font-size: .92rem; }
th, td { border: 1px solid #d8dbe0; padding: .35rem .6rem; text-align: left; }
th { background: #f2f3f5; }
img { max-width: 100%; }
.api-sig { background: #f6f8fa; border-left: 3px solid #8aa;
           padding: .4rem .8rem; font-family: monospace; font-size: .88rem;
           white-space: pre-wrap; margin: .8rem 0 .3rem; }
.api-doc { margin: .2rem 0 1rem 1rem; white-space: pre-wrap;
           font-size: .92rem; color: #333; }
.member { margin-left: 1.2rem; }
.inherited { margin: .3rem 0 .3rem 1.2rem; font-size: .92rem; color: #445; }
"""


def _md():
    from markdown_it import MarkdownIt
    from pygments import highlight
    from pygments.formatters import HtmlFormatter
    from pygments.lexers import get_lexer_by_name
    from pygments.util import ClassNotFound

    def hl(code, lang, _attrs):
        if not lang:
            return ""
        try:
            lexer = get_lexer_by_name(lang)
        except ClassNotFound:
            return ""  # markdown-it escapes the block as it is
        return highlight(code, lexer, HtmlFormatter(nowrap=True))

    md = MarkdownIt("commonmark", {"html": True}).enable("table")
    md.options["highlight"] = hl
    return md


def _slug(module_name):
    return "api_" + module_name.replace(".", "_")


def _short(module_name):
    return module_name[len(PACKAGE) + 1:] if module_name != PACKAGE else PACKAGE


def _page(title, nav_html, body):
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)} — {PACKAGE}</title>
<style>{CSS}</style></head><body><div class="layout">
<nav><h2>{PACKAGE}</h2>{nav_html}</nav>
<main>{body}</main></div></body></html>"""


def _nav(current, api_names):
    parts = ["<h2>Guide</h2>"]
    for slug, title in [(p[0], p[2]) for p in PAGES] + [DIFFERENCES_PAGE]:
        cls = ' class="current"' if slug == current else ""
        parts.append(f'<a href="{slug}.html"{cls}>{html.escape(title)}</a>')
    parts.append('<h2>Diagrams</h2><a href="diagrams.html">Architecture</a>')
    parts.append("<h2>API reference</h2>")
    for name in api_names:
        cls = ' class="current"' if _slug(name) == current else ""
        parts.append(f'<a href="{_slug(name)}.html"{cls}>{html.escape(_short(name))}</a>')
    return "\n".join(parts)


def cut_section(text, heading):
    """The lines of ``text`` from the line ``heading`` to the next heading of
    its level or higher outside a fenced code block (or the end)."""
    lines = text.splitlines(keepends=True)
    level = len(heading) - len(heading.lstrip("#"))
    try:
        start = [ln.rstrip("\n") for ln in lines].index(heading)
    except ValueError:
        raise ValueError(f"no line {heading!r} to cut the section from") from None
    fenced = False
    for end in range(start + 1, len(lines)):
        line = lines[end]
        if line.startswith("```"):
            fenced = not fenced
        hashes = len(line) - len(line.lstrip("#"))
        if not fenced and 0 < hashes <= level and line[hashes:hashes + 1] == " ":
            return "".join(lines[start:end])
    return "".join(lines[start:])


def guide_sources():
    """{slug: markdown} of the guide pages; a missing source raises
    :class:`FileNotFoundError` naming it."""
    sources = {}
    for slug, rel, _, section in PAGES:
        path = os.path.join(REPO, rel)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"guide source {rel} not found ({path})")
        with open(path, encoding="utf-8") as f:
            text = f.read()
        sources[slug] = cut_section(text, section) if section else text
    return sources


def _import_error(name, exc):
    return ImportError(f"cannot document {name}: it failed to import "
                       f"({type(exc).__name__}: {exc})", name=name)


def _import(name):
    try:
        return importlib.import_module(name)
    except Exception as exc:
        raise _import_error(name, exc) from exc


def walk_modules():
    """The names of the package and of every module under it, in pkgutil's
    order (a package before its modules).  A package that fails to import
    raises."""
    package = _import(PACKAGE)

    def fail(name):  # called inside pkgutil's handler of the import's error
        exc = sys.exc_info()[1]
        raise _import_error(name, exc) from exc

    return [PACKAGE] + [info.name for info in pkgutil.walk_packages(
        package.__path__, PACKAGE + ".", onerror=fail)]


def api_members(mod):
    """(classes, functions) defined in this module, each as (name, object),
    in source order."""
    classes, funcs = [], []
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            classes.append((name, obj))
        elif inspect.isfunction(obj):
            funcs.append((name, obj))

    def line(item):
        try:
            return inspect.getsourcelines(item[1])[1]
        except (OSError, TypeError):
            return 1 << 30

    return sorted(classes, key=line), sorted(funcs, key=line)


def api_modules():
    """The modules that get an API page: the package root and every module
    that defines a public class or function.  A module that fails to import
    raises :class:`ImportError` naming it."""
    modules = [_import(name) for name in walk_modules()]
    return [m for m in modules if m.__name__ == PACKAGE or any(api_members(m))]


def _sig(obj, name):
    try:
        return f"{name}{inspect.signature(obj)}"
    except (ValueError, TypeError):
        return name


def _doc(obj):
    d = inspect.getdoc(obj) or ""
    return f'<div class="api-doc">{html.escape(d)}</div>' if d else ""


def class_members(cls):
    """(name, object, owner) of the public methods and properties of ``cls``
    (``__call__`` included): ``owner`` is the class of the MRO that defines
    it.  Methods inherited from outside the package are left out, as
    builtins are."""
    members = []
    for mname, m in inspect.getmembers(cls):
        if mname.startswith("_") and mname != "__call__":
            continue
        static = inspect.getattr_static(cls, mname, None)
        if not (inspect.isfunction(m) or isinstance(static, property)):
            continue
        owner = next(base for base in cls.__mro__ if mname in vars(base))
        if owner is not cls and not owner.__module__.startswith(PACKAGE):
            continue
        members.append((mname, m, owner))
    return members


def _member_html(cls, mname, m, owner):
    is_property = isinstance(inspect.getattr_static(owner, mname), property)
    if owner is not cls:
        label = f"property {mname}" if is_property else f"{mname}(...)"
        link = f"{_slug(owner.__module__)}.html#{owner.__name__}"
        return (f'<div class="member inherited"><code>{html.escape(label)}</code>: '
                f'inherited from <a href="{link}"><code>{owner.__name__}</code></a></div>')
    if is_property:
        return (f'<div class="member">\n<div class="api-sig">property {html.escape(mname)}'
                f"</div>\n{_doc(inspect.getattr_static(owner, mname))}\n</div>")
    return (f'<div class="member">\n<div class="api-sig">{html.escape(_sig(m, mname))}'
            f"</div>\n{_doc(m)}\n</div>")


def _replaces_html(short):
    source, kernels = REPLACES[short]
    cited = ", ".join(f"<code>{k}</code> (<code>{where}</code>)" for k, where in kernels)
    return (f"<p>The wrappers of this module launch <code>{PACKAGE}/{source}</code>, "
            f"the hand-written <code>sm_90a</code> port of {cited}; each "
            f"<code>*_reference</code> is its plain PyTorch version.</p>")


def api_page_body(mod):
    """The API page of module ``mod``: its docstring, then each public class
    (signature, docstring, members) and function in source order."""
    short = _short(mod.__name__)
    body = [f"<h1><code>{html.escape(mod.__name__)}</code></h1>", _doc(mod)]
    if short in REPLACES:
        body.append(_replaces_html(short))
    classes, funcs = api_members(mod)
    for name, cls in classes:
        body.append(f'<h2 id="{name}">class {html.escape(name)}</h2>')
        body.append(f'<div class="api-sig">class {html.escape(_sig(cls, name))}</div>')
        body.append(_doc(cls))
        body += [_member_html(cls, mname, m, owner)
                 for mname, m, owner in class_members(cls)]
    for name, fn in funcs:
        body.append(f'<h2 id="{name}">{html.escape(name)}</h2>')
        body.append(f'<div class="api-sig">{html.escape(_sig(fn, name))}</div>')
        body.append(_doc(fn))
    return "\n".join(body)


def differences_body():
    """The page of :data:`DIFFERENCES`."""
    rows = []
    for d in DIFFERENCES:
        module = f"{PACKAGE}.{d.module}"
        names = ", ".join(f"<code>{n}</code>" for n in d.names)
        rows.append(f'<tr><td><a href="{_slug(module)}.html"><code>{d.module}</code></a></td>'
                    f"<td>{names}</td><td>{d.text}</td><td>{html.escape(d.reason)}</td></tr>")
    return (
        "<h1>Differences from ccvm_tpu</h1>"
        "<p>The names that the JAX package's API reference (its "
        "<code>tools/build_docs.py</code>) lists and that the port leaves out, "
        "takes with other parameters or defaults, or inherits where the JAX "
        "class defines them. Modules are named relative to either package. All "
        "are by design. The port's own additions (kernel wrappers, build and "
        "host tools, helpers) are on its API pages and are not listed. The JAX "
        "package's <code>ops.pallas_kernels</code> has no single twin: its "
        "kernels are wrapped by <code>ops.dl_kernels</code>, "
        "<code>ops.mf_kernels</code>, <code>ops.langevin_kernels</code> and "
        "<code>ops.dl_variant_kernels</code>, whose pages say which kernel each "
        "launches. <code>tests/test_torch_build_docs.py</code> holds this table "
        "equal to an introspection of both packages.</p>"
        "<table><tr><th>Module</th><th>Names</th><th>Difference</th><th>Why</th></tr>"
        + "".join(rows) + "</table>")


def build_diagrams(out_dir):
    """The port's layer map and solver hierarchy, as PNGs in ``out_dir``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import FancyArrowPatch, FancyBboxPatch

    def box(ax, x, y, w, h, label, fc="#eef1f6", fontsize=8.5):
        ax.add_patch(FancyBboxPatch((x, y), w, h, boxstyle="round,pad=0.012",
                                    fc=fc, ec="#5a6b82", lw=1.0))
        ax.text(x + w / 2, y + h / 2, label, ha="center", va="center", fontsize=fontsize)

    def arrow(ax, x0, y0, x1, y1):
        ax.add_patch(FancyArrowPatch((x0, y0), (x1, y1), arrowstyle="-|>",
                                     mutation_scale=11, color="#5a6b82", lw=1.0))

    # ---- the layer map, from the entry points down to the card ----------
    fig, ax = plt.subplots(figsize=(9.2, 7.0))
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.axis("off")
    ax.set_title("ccvm_tpu_torch architecture (layer map, PyTorch and CUDA)", fontsize=11)
    rows = [
        (0.88, [("examples/torch_port/  (study, examples, tuner)", 0.02, 0.46),
                ("ccvmplotlib  (TTS / ETS plots; host-only:\npandas, matplotlib)",
                 0.52, 0.46)]),
        (0.74, [("Solution (float64 gap statistics)", 0.02, 0.29),
                ("Metadata JSON", 0.35, 0.19),
                ("checkpoint / profiling / tuning", 0.58, 0.40)]),
        (0.60, [("solver façades: DL | MF | Langevin | Pumped\n(the JAX package's API)",
                 0.02, 0.54),
                ("post_processor (grad-descent, Adam, ASGD,\nBFGS, L-BFGS: torch "
                 "on the tensor's device)", 0.60, 0.38)]),
        (0.46, [("dynamics/*: plain step functions\n(the kernels' plain versions)",
                 0.02, 0.46),
                ("parallel/: DP, TP, sweeps\non torch.distributed (NCCL / gloo)",
                 0.52, 0.46)]),
        (0.32, [("ops/*_kernels.py → csrc/*.cu: DL's 3xTF32 mma.sync; MF's and the\n"
                 "Langevin family's fp32; one Philox4x32-10 stream. Built by\n"
                 "ops/build.py with nvcc for sm_90a into build/kernels at first use",
                 0.02, 0.65),
                ("native/ccvm_io.cpp\n(g++, build/native): .in tokenizer,\n"
                 "evolution writer", 0.71, 0.27)]),
        (0.18, [("PyTorch (tensors, torch.distributed) · ctypes", 0.02, 0.46),
                ("problem_classes.boxqp (parser,\nfloat64-grade readout)", 0.52, 0.46)]),
        (0.04, [("NVIDIA H100 (Hopper, sm_90a): tensor cores (TF32 mma.sync) · "
                 "CUDA cores · (batch, N) state on the card", 0.02, 0.96)]),
    ]
    for y, boxes in rows:
        for label, x, w in boxes:
            box(ax, x, y, w, 0.10, label)
    for y in (0.88, 0.74, 0.60, 0.46, 0.32, 0.18):
        arrow(ax, 0.5, y, 0.5, y - 0.04)
    fig.savefig(os.path.join(out_dir, "architecture.png"), dpi=150, bbox_inches="tight")
    plt.close(fig)

    # ---- the solver hierarchy ------------------------------------------
    fig, ax = plt.subplots(figsize=(9.2, 5.4))
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.axis("off")
    ax.set_title("Solver hierarchy and compute paths", fontsize=11)
    box(ax, 0.30, 0.85, 0.40, 0.11,
        "CCVMSolver (solvers.base)\nscaling · machine time / energy · tune · DP",
        fc="#e4ecdf")
    solvers = [("DLSolver", "dl", "dl_kernels", "dl_solve", 0.02),
               ("MFSolver", "mf", "mf_kernels", "mf_solve", 0.27),
               ("LangevinSolver", "langevin", "langevin_kernels", "langevin_solve", 0.52),
               ("PumpedLangevinSolver", "pumped_langevin", "langevin_kernels",
                "langevin_solve", 0.77)]
    for name, family, wrapper, source, x in solvers:
        box(ax, x, 0.64, 0.21, 0.09, name)
        arrow(ax, x + 0.105, 0.73, 0.5, 0.85)
        box(ax, x, 0.44, 0.21, 0.12, f'ops.{wrapper}\n"cuda": csrc/{source}.cu',
            fc="#efe2e6", fontsize=7.5)
        box(ax, x, 0.24, 0.21, 0.12, f'dynamics.{family}\n"cpu": the plain version\n'
            "(step + Adam step)", fc="#f6efe2", fontsize=7.5)
        arrow(ax, x + 0.105, 0.64, x + 0.105, 0.56)
        arrow(ax, x + 0.105, 0.44, x + 0.105, 0.36)
        arrow(ax, x + 0.105, 0.24, 0.5, 0.155)
    box(ax, 0.06, 0.03, 0.88, 0.12,
        "parallel.tp: the tensor-parallel engine\nmatmul of a rank's Q rows · "
        "reduce-scatter (tp_matvec) · each template's one-step build", fc="#efe2e6")
    fig.savefig(os.path.join(out_dir, "solver_hierarchy.png"), dpi=150,
                bbox_inches="tight")
    plt.close(fig)


def main(argv=None):
    """Build the site into ``--out`` (default docs/_build/torch_html)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT, help="output directory (default %(default)s)")
    out = os.path.abspath(parser.parse_args(argv).out)
    if out != OUT and os.path.isdir(out) and os.listdir(out):
        raise FileExistsError(f"{out} is not empty: give a new directory")

    sources = guide_sources()
    modules = api_modules()
    api_names = [m.__name__ for m in modules]
    md = _md()
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "diagrams"))

    def write(slug, title, body):
        with open(os.path.join(out, f"{slug}.html"), "w", encoding="utf-8") as f:
            f.write(_page(title, _nav(slug, api_names), body))

    for slug, _, title, _ in PAGES:
        body = md.render(sources[slug])
        write(slug, title, PREFACE + body if slug == "index" else body)
    write(*DIFFERENCES_PAGE, differences_body())
    for mod in modules:
        write(_slug(mod.__name__), mod.__name__, api_page_body(mod))
    build_diagrams(os.path.join(out, "diagrams"))
    write("diagrams", "Diagrams", (
        "<h1>Diagrams</h1><p>Drawn by <code>ccvm_tpu_torch/tools/build_docs.py</code> "
        "(counterparts of the JAX package's).</p>"
        '<h2>Architecture</h2><img src="diagrams/architecture.png">'
        '<h2>Solver hierarchy</h2><img src="diagrams/solver_hierarchy.png">'))
    print(f"built {len(PAGES) + 1} guide pages + {len(modules)} API pages + "
          f"2 diagrams -> {out}/index.html")


if __name__ == "__main__":
    main()
