"""The port's standing-policy lint (``repro_torch.analysis.lint``): the
port is clean, and each rule fires on a violating snippet — the
reference's ``tests/test_lint.py`` cases of the rules that have a
counterpart in the port (L002, L005, L006), the port's L008 (a library
convolution in a backward path outside the ``_library_*`` rung) and a
syntax error as a finding."""

import subprocess
import sys
import textwrap

from repro_torch.analysis import lint

_CLOCKY = """
    import time

    def tick():
        t0 = time.monotonic()
        time.sleep(0.01)
        return time.perf_counter() - t0
    """


def _lint_snippet(tmp_path, code, name="snippet.py"):
    f = tmp_path / name
    f.write_text(textwrap.dedent(code))
    return lint.lint_file(f)


def test_port_is_lint_clean():
    findings = lint.lint_repo()
    assert not findings, "\n".join(str(f) for f in findings)


def test_lint_repo_covers_the_port_and_the_chip_smoke(tmp_path):
    (tmp_path / "src" / "repro_torch" / "serve").mkdir(parents=True)
    (tmp_path / "src" / "repro_torch" / "serve" / "loop.py").write_text(
        textwrap.dedent(_CLOCKY))
    (tmp_path / "chip_smoke.py").write_text(textwrap.dedent("""
        import torch.nn.functional as F

        def phase_dgrad(x, w):
            return F.conv2d(x, w)
        """))
    (tmp_path / "src" / "repro").mkdir()          # not the port's
    (tmp_path / "src" / "repro" / "serve.py").write_text("import hypothesis\n")
    rules = sorted(f.rule for f in lint.lint_repo(tmp_path))
    assert rules == ["L005", "L005", "L005", "L008"]


def test_cli_exits_zero_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint"],
        capture_output=True, text=True, cwd=str(lint.repo_root()))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: clean" in proc.stdout


def test_cli_exits_one_on_a_finding(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import hypothesis\n")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", str(bad)],
        capture_output=True, text=True, cwd=str(lint.repo_root()))
    assert proc.returncode == 1
    assert "L002" in proc.stdout and "lint: 1 error(s)" in proc.stdout


def test_L002_flags_direct_hypothesis_import(tmp_path):
    rules = {f.rule for f in _lint_snippet(tmp_path, """
        import hypothesis
        from hypothesis import given
        """)}
    assert rules == {"L002"}
    # the compat shim itself is exempt
    assert not _lint_snippet(tmp_path, "import hypothesis\n",
                             name="_hypothesis_compat.py")


def test_L005_flags_bare_clock_calls_in_serve_and_runtime(tmp_path):
    for scope in ("serve", "runtime"):
        d = tmp_path / scope
        d.mkdir()
        (d / "loopy.py").write_text(textwrap.dedent(_CLOCKY))
        rules = [f.rule for f in lint.lint_file(d / "loopy.py")]
        assert rules == ["L005", "L005", "L005"], scope


def test_L005_allows_clock_parameter_defaults(tmp_path):
    d = tmp_path / "serve"
    d.mkdir()
    (d / "injected.py").write_text(textwrap.dedent("""
        import time

        def run(clock=time.monotonic, *, sleep=time.sleep):
            sleep(0.0)
            return clock()
        """))
    assert not lint.lint_file(d / "injected.py")


def test_L005_is_scoped_to_serve_and_runtime_paths(tmp_path):
    assert not _lint_snippet(tmp_path, _CLOCKY)


def test_L006_flags_bare_clock_calls_inside_obs(tmp_path):
    d = tmp_path / "obs"
    d.mkdir()
    (d / "tracey.py").write_text(textwrap.dedent(_CLOCKY))
    rules = [f.rule for f in lint.lint_file(d / "tracey.py")]
    assert rules == ["L006", "L006", "L006"]


def test_L006_allows_clock_defaults_and_injected_clocks_in_obs(tmp_path):
    d = tmp_path / "obs"
    d.mkdir()
    (d / "tracer.py").write_text(textwrap.dedent("""
        import time

        class Tracer:
            def __init__(self, clock=time.perf_counter):
                self._clock = clock

            def now(self):
                return self._clock()
        """))
    assert not lint.lint_file(d / "tracer.py")


def test_L006_flags_set_active_mutation_outside_obs(tmp_path):
    rules = {f.rule for f in _lint_snippet(tmp_path, """
        from repro_torch.obs.tracer import set_active

        def hijack(tracer):
            set_active(tracer)
        """)}
    assert rules == {"L006"}
    rules = {f.rule for f in _lint_snippet(tmp_path, """
        from repro_torch.obs import tracer as trc

        def hijack(t):
            trc.set_active(t)
        """, name="other.py")}
    assert rules == {"L006"}


def test_L006_allows_set_active_inside_obs_and_activate_scopes(tmp_path):
    d = tmp_path / "obs"
    d.mkdir()
    (d / "tracer.py").write_text(textwrap.dedent("""
        def set_active(tracer):
            return tracer

        class _Activation:
            def __enter__(self):
                return set_active(self)
        """))
    assert not lint.lint_file(d / "tracer.py")
    assert not _lint_snippet(tmp_path, """
        def run(tracer):
            with tracer.activate():
                pass
        """)


def test_L008_flags_library_convs_in_backward_paths(tmp_path):
    findings = _lint_snippet(tmp_path, """
        import torch
        import torch.nn.functional as F

        def dgrad_lb(gy, w):
            dx = F.conv2d(gy, w)

            def inner():                  # closure is still backward
                return torch.nn.functional.conv_transpose2d(gy, w)

            return dx, inner()

        class ConvLb:
            @staticmethod
            def backward(ctx, g):
                return torch.nn.grad.conv2d_input((1, 1, 4, 4), g, g)

        def _wgrad(x, gy):
            return torch.nn.grad.conv2d_weight(x, (1, 1, 3, 3), gy)
        """)
    assert [f.rule for f in findings] == ["L008"] * 4
    assert [f.line for f in findings] == [6, 9, 16, 19]


def test_L008_exempts_the_library_rung_and_forward_paths(tmp_path):
    assert not _lint_snippet(tmp_path, """
        import torch
        import torch.nn.functional as F

        def _library_dgrad(x, w, gy):
            return torch.nn.grad.conv2d_input(x.shape, w, gy)

        def backward(ctx, g):
            def _library_vjp():           # an enclosing _library_* one
                return F.conv2d(g, g)

            return _library_vjp()

        def forward(x, w):                # not a backward path at all
            return F.conv2d(x, w)

        def dgrad_lb(gy, w):              # a kernel call, not a library one
            return conv_lb(gy, w)
        """)


def test_syntax_errors_are_findings_not_crashes(tmp_path):
    findings = _lint_snippet(tmp_path, "def broken(:\n")
    assert findings and findings[0].rule == "parse"
