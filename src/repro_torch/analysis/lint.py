"""AST-based standing-policy lint of the port
(``python -m repro_torch.analysis.lint``) — the port's copy of the frame
of ``repro/analysis/lint.py:127-392`` (:class:`Finding`,
:func:`lint_file`, :func:`lint_paths`, :func:`lint_repo`, :func:`main`),
with the rules that have a counterpart in the port:

``L002`` ``hypothesis`` must be imported only through
``tests/_hypothesis_compat``: the container has no hypothesis wheel,
and the compat module degrades to a deterministic sampler instead of
a collection error.

``L005`` No bare wall-clock / sleep call inside ``serve/`` or
``runtime/`` modules: serving loops must take an injectable
``clock=``/``sleep=`` (references in *parameter defaults* like
``clock=time.monotonic`` are the sanctioned idiom), or the loop can
never run under the virtual time the chaos suite depends on.

``L006`` Observability must stay deterministic and injectable: (a) no
bare wall-clock / sleep call inside ``obs/`` modules — the tracer's
``clock=`` is the *only* time source; (b) no ``set_active(...)``
ambient-tracer mutation outside ``obs/`` — instrumented code takes
``tracer=`` or scopes the swap with ``with tracer.activate():``.

``L008`` No ``F.conv*`` / ``torch.nn.functional.conv*`` /
``torch.nn.grad.*`` call inside a backward code path (functions whose
names mention ``bwd``/``backward``/``dgrad``/``wgrad``) unless an
enclosing function is a ``_library_*`` one: the backward executes
through K1 and K2, and the only sanctioned library escape is the loud,
counted library rung of ``kernels/conv_lb/ops.py`` (``_library_conv``,
``_library_vjp``, ``_library_dgrad``) — a quiet cuDNN call in a
gradient path would un-do the paper dataflow while every plan still
claims it rode the kernel.

The reference's ``L001`` (``shard_map`` imports), ``L003``
(``interpret=True`` defaults), ``L004`` (0-d ``shard_map`` returns)
and ``L007`` (raw ``interpret=`` keywords) police JAX and Pallas idioms
the port has no counterpart of, and are not ported.  The rule that the
port imports neither ``jax`` nor the reference package is
``tests/test_torch_imports.py``'s.

Exit status 0 when the tree is clean, 1 otherwise.
"""

from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path

#: rule id -> one-line meaning (the reference's texts; L008 the port's)
LINT_RULES = {
    "L002": "hypothesis imported outside tests/_hypothesis_compat",
    "L005": "bare wall-clock/sleep call in serve/runtime (inject clock=)",
    "L006": "bare clock in obs/, or set_active tracer mutation outside obs/",
    "L008": "F.conv*/torch.nn.grad.* in a backward path outside _library_*",
}

#: path fragments (posix) that exempt a file from a rule
_ALLOW = {
    "L002": ("_hypothesis_compat.py",),
    "L005": (),
    "L006": (),
    "L008": (),
}

#: function-name fragments marking a backward code path (L008 scope)
_BWD_NAME_FRAGMENTS = ("bwd", "backward", "dgrad", "wgrad")

#: the name prefix of the library rung's functions (L008's exemption)
_LIBRARY_PREFIX = "_library_"

#: call chains L008 reads as a library convolution or its gradient
_LIBRARY_CONV_HEADS = ("F", "torch.nn.functional", "nn.functional",
                       "functional")

#: path fragments marking the observability package (L006's pivot:
#: clock calls are banned *inside*, set_active calls *outside*)
_OBS_FRAGMENTS = ("/obs/",)

#: path fragments a rule is *scoped to* (empty: applies everywhere)
_ONLY = {
    "L005": ("/serve/", "/runtime/"),
}

#: wall-clock call chains L005 rejects outside parameter defaults
_CLOCK_CALLS = {"time.monotonic", "time.sleep", "time.time",
                "time.perf_counter"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One policy violation: ``file:line rule message``."""

    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _allowed(path: str, rule: str) -> bool:
    p = Path(path).as_posix()
    only = _ONLY.get(rule, ())
    if only and not any(frag in p for frag in only):
        return True                      # rule is scoped elsewhere
    return any(frag in p for frag in _ALLOW[rule])


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain ('' when not one)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _library_conv(chain: str) -> bool:
    """``chain`` names a library convolution (``F.conv2d``,
    ``torch.nn.functional.conv_transpose2d``, ...) or one of
    ``torch.nn.grad``'s gradients."""
    head, _, tail = chain.rpartition(".")
    return ((tail.startswith("conv") and head in _LIBRARY_CONV_HEADS)
            or head in ("torch.nn.grad", "nn.grad"))


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        # enclosing function names, outermost first — L008 resolves a
        # call site against the whole lexical chain (a closure inside
        # backward is still a backward path; a closure inside
        # _library_dgrad is still sanctioned)
        self.fn_stack: list[str] = []

    def _emit(self, rule: str, line: int, message: str) -> None:
        if not _allowed(self.path, rule):
            self.findings.append(Finding(rule=rule, path=self.path,
                                         line=line, message=message))

    # -- L002: import provenance ----------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if alias.name.split(".")[0] == "hypothesis":
                self._emit("L002", node.lineno,
                           "import hypothesis directly — use "
                           "tests/_hypothesis_compat")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if mod.split(".")[0] == "hypothesis":
            self._emit("L002", node.lineno,
                       f"from {mod} import ... — use "
                       "tests/_hypothesis_compat")
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self.fn_stack.append(node.name)
        try:
            self.generic_visit(node)
        finally:
            self.fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- L005 / L006 / L008: call sites ----------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        chain = _attr_chain(node.func)
        in_obs = any(frag in Path(self.path).as_posix()
                     for frag in _OBS_FRAGMENTS)
        if chain in _CLOCK_CALLS:
            self._emit("L005", node.lineno,
                       f"{chain}() called directly — take an "
                       "injectable clock=/sleep= (defaults like "
                       "clock=time.monotonic are fine)")
            if in_obs:
                self._emit("L006", node.lineno,
                           f"{chain}() called inside obs/ — the "
                           "tracer's injectable clock= is the only "
                           "time source (defaults like "
                           "clock=time.perf_counter are fine)")
        if (chain == "set_active" or chain.endswith(".set_active")) \
                and not in_obs:
            self._emit("L006", node.lineno,
                       "set_active() mutates the ambient tracer "
                       "outside obs/ — pass tracer= or scope it "
                       "with `with tracer.activate():`")
        if _library_conv(chain) \
                and any(frag in name for name in self.fn_stack
                        for frag in _BWD_NAME_FRAGMENTS) \
                and not any(name.startswith(_LIBRARY_PREFIX)
                            for name in self.fn_stack):
            self._emit("L008", node.lineno,
                       f"{chain}() inside a backward path — gradients "
                       "execute through K1 and K2; the only library "
                       "escape is a _library_* function of the library "
                       "rung, which records itself via record_fallback")
        self.generic_visit(node)


def lint_file(path: str | Path) -> list[Finding]:
    """Lint one source file; syntax errors are findings, not crashes."""
    path = Path(path)
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(rule="parse", path=str(path),
                        line=e.lineno or 0, message=str(e.msg))]
    linter = _Linter(str(path))
    linter.visit(tree)
    return linter.findings


def repo_root() -> Path:
    """`<root>/src/repro_torch/analysis/lint.py` -> `<root>`."""
    return Path(__file__).resolve().parents[3]


def lint_paths(paths) -> list[Finding]:
    """Lint files and/or directory trees (``.py`` files, recursively)."""
    findings: list[Finding] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f))
    return findings


def lint_repo(root: str | Path | None = None) -> list[Finding]:
    """Lint the port: ``src/repro_torch/`` and ``chip_smoke.py``."""
    root = Path(root) if root is not None else repo_root()
    targets = [root / "src" / "repro_torch", root / "chip_smoke.py"]
    return lint_paths([t for t in targets if t.exists()])


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    findings = lint_paths(argv) if argv else lint_repo()
    for f in findings:
        print(f)
    n = len(findings)
    print(f"lint: {n} error(s)" if n else "lint: clean")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
