"""The port's ``pipeline_observatory`` against the JAX package's, on the
CPU, tolerance 0.

Every case of tests/test_pipeline_observatory.py (each parametrised
depth a case of its own) runs on both packages, in the manner of
tests/test_torch_storage.py: the JAX file executed as written, then
with its imports read as the port's; its helper module
tests/test_wave_builder.py (``make_dht``, ``fake_launch``, ``_pump``) is
read the same way for the port's run, and the port's ``Dht`` it builds
takes the CPU for its default device.  The wave builder stamps each
wave's edges with ``time.time()``, a history frame its wall time, and
an observatory built without a clock reads the same wall clock: for
their readings (and theirs only: JAX's dispatch reads it too) both runs
see a clock that starts at one instant and steps 1 ms a reading, so
their stamps agree; each run counts into a fresh metrics registry.
Both runs must pass the case's assertions and make the same calls into
the observatory, the history hook and the health signal with the same
results: every function of ``pipeline_observatory.py``, ``history.py``
and ``health.py`` that returns, in order, and what it returned.
"""

from __future__ import annotations

import ast
import sys
import time
import types

import pytest

from test_torch_cluster_tools import cpu_by_default
from test_torch_storage import _IMPORT, PACKAGES, TESTS, traced_returns

FNAME = "test_pipeline_observatory.py"
# the observatory, and the history hook and health signal two cases pin
OBS_FILES = ("pipeline_observatory.py", "history.py", "health.py")


def _namespace(fname: str, pkg: str, helpers=None) -> dict:
    """tests/<fname> executed as written (``"jax"``) or with its imports
    read as the port's; ``helpers`` (name → namespace) stand in for the
    test modules it imports while it runs."""
    path = TESTS / fname
    src = path.read_text()
    if pkg == "port":
        src = _IMPORT.sub(r"\1\2 opendht_tpu_torch", src)
    saved = {}
    for name, ns in (helpers or {}).items():
        mod = types.ModuleType(name)
        mod.__dict__.update(ns)
        saved[name] = sys.modules.get(name)
        sys.modules[name] = mod
    try:
        ns = {"__name__": "twin_%s_%s" % (pkg, path.stem),
              "__file__": str(path)}
        exec(compile(src, str(path), "exec"), ns)
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
    return ns


_NS = {}


CLOCK_READERS = ("wave_builder.py", "pipeline_observatory.py", "history.py")


def stepping_clock():
    """``time.time`` for a twin run: a clock that starts at a fixed
    instant and moves 1 ms at each reading from CLOCK_READERS (or from
    an observatory's default clock), the real one for anyone else."""
    n, real = [0], time.time

    def now():
        code = sys._getframe(1).f_code
        if code is not _observatory_clock.__code__ and \
                not code.co_filename.endswith(CLOCK_READERS):
            return real()
        n[0] += 1
        return 1_760_000_000.0 + n[0] * 1e-3
    return now


def _observatory_clock():
    return time.time()


def fresh_registry(m, pkg: str) -> None:
    """``pkg``'s process-global metrics registry, fresh for one run: the
    observatory counts into it, and the tests that ran before in this
    process filled each package's differently."""
    tel = __import__(PACKAGES[pkg] + ".telemetry",
                     fromlist=["MetricsRegistry"])
    reg = tel.MetricsRegistry()
    m.setattr(tel, "_global_registry", reg, raising=False)
    m.setattr(tel, "get_registry", lambda: reg)


def default_clock_is_time_time(m, pkg: str) -> None:
    """An observatory built without ``clock=`` reads ``time.time`` when it
    runs (its default was bound to the real function when the module was
    loaded)."""
    mod = __import__(PACKAGES[pkg] + ".pipeline_observatory",
                     fromlist=["PipelineObservatory"])
    init = mod.PipelineObservatory.__init__
    config, registry, _ = init.__defaults__
    m.setattr(init, "__defaults__", (config, registry, _observatory_clock))


def namespace(pkg: str) -> dict:
    if pkg not in _NS:
        helpers = None
        if pkg == "port":
            helpers = {"test_wave_builder": _namespace(
                "test_wave_builder.py", "port")}
        _NS[pkg] = _namespace(FNAME, pkg, helpers)
    return _NS[pkg]


def expand_cases(fname: str) -> list:
    """``(case id, function name, kwargs)`` of every top-level test of
    tests/<fname>, one per value of a ``parametrize`` over a name."""
    tree = ast.parse((TESTS / fname).read_text())
    consts = {n.targets[0].id: ast.literal_eval(n.value) for n in tree.body
              if isinstance(n, ast.Assign) and len(n.targets) == 1
              and isinstance(n.targets[0], ast.Name)
              and isinstance(n.value, (ast.Tuple, ast.List))}
    out = []
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        params = None
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Call) and ast.unparse(dec.func) \
                    == "pytest.mark.parametrize":
                arg, vals = dec.args
                vals = (consts[vals.id] if isinstance(vals, ast.Name)
                        else ast.literal_eval(vals))
                params = [(f"{fn.name}[{v}]", {ast.literal_eval(arg): v})
                          for v in vals]
        out += params or [(fn.name, {})]
    return [(cid, cid.split("[")[0], kw) for cid, kw in out]


CASES = expand_cases(FNAME)


def test_every_case_is_twinned():
    # 20 functions; three of them parametrised over 3, 2 and 3 depths
    assert len({n for _, n, _ in CASES}) == 20
    assert len(CASES) == 17 + 3 + 2 + 3


@pytest.mark.parametrize("cid,name,kwargs", CASES,
                         ids=[c[0] for c in CASES])
def test_observatory_case_twin(cid, name, kwargs, monkeypatch):
    recs = {}
    for pkg in ("jax", "port"):
        case = namespace(pkg)[name]
        with monkeypatch.context() as m:
            m.setattr(time, "time", stepping_clock())
            default_clock_is_time_time(m, pkg)
            fresh_registry(m, pkg)
            if pkg == "port":
                cpu_by_default(m)
            recs[pkg] = traced_returns(lambda: case(**kwargs), pkg,
                                       OBS_FILES)
    assert recs["jax"], "the case reached no traced function"
    assert recs["port"] == recs["jax"]
