"""The port's boundaries: it imports neither JAX nor the JAX package, only
its etcd3 front imports ``grpc`` and ``protobuf``, the wiring below the
front loads without them, its entry points default to the card and raise
without one, and ``chip_smoke.py`` refuses to run where it cannot
measure."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from kubebrain_tpu_torch import _build
from kubebrain_tpu_torch.device import resolve_device
from kubebrain_tpu_torch.storage import new_storage
from kubebrain_tpu_torch.storage.cuda.engine import CudaKvStorage

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kubebrain_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "kubebrain_tpu", "grpc", "google", "bench")
#: the etcd3 front and its client side: the only port files that may
#: import ``grpc`` and ``google.protobuf`` (the card's machine has neither);
#: ``replica/role.py`` only inside its forwarding paths and
#: ``workload/runner.py`` only inside its gRPC transport
FRONT = ("kubebrain_tpu_torch/proto/", "kubebrain_tpu_torch/server/",
         "kubebrain_tpu_torch/endpoint/", "kubebrain_tpu_torch/cli.py",
         "kubebrain_tpu_torch/client.py", "kubebrain_tpu_torch/tools.py",
         "kubebrain_tpu_torch/replica/role.py",
         "kubebrain_tpu_torch/workload/runner.py")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_jax_package(path):
    forbidden = set(FORBIDDEN)
    if str(path.relative_to(ROOT)).startswith(FRONT):
        forbidden -= {"grpc", "google"}
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in forbidden, f"{path.name} imports {mod}"


def test_default_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_engine_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        new_storage("cuda", inner="memkv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CudaKvStorage(new_storage("memkv"))
    store = new_storage("cuda", inner="memkv", device="cpu")
    assert store.make_scanner(get_compact_revision=lambda _s: 0)._device.type == "cpu"
    store.close()


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setattr(os.path, "exists", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_every_cuda_source_is_compiled_for_sm_90a():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == [
        "compact_victims", "fanout_match", "scan_visibility"]
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def _smoke(cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_card():
    # this CPU-only interpreter: no card, so no result line and a non-zero exit
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_watch_ab_fails_without_card():
    """The A/B watch drive measures on a card or not at all: without one
    it fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--watch-ab", "."],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert '"tree"' not in out.stdout


def _module_file(name: str):
    """The file of the dotted module ``name`` in the checkout, or None."""
    base = ROOT.joinpath(*name.split("."))
    for path in (base / "__init__.py", base.with_suffix(".py")):
        if path.exists():
            return path
    return None


def _import_time_names(path: pathlib.Path, modname: str):
    """The modules an import of ``path`` (module ``modname``) imports
    while it runs: its import statements outside function bodies."""
    is_pkg = path.name == "__init__.py"
    package = modname if is_pkg else modname.rpartition(".")[0]

    def visit(nodes):
        for node in nodes:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = package.rsplit(".", node.level - 1)[0] \
                        if node.level > 1 else package
                    base = f"{base}.{node.module}" if node.module else base
                else:
                    base = node.module
                yield base
                for a in node.names:
                    if _module_file(f"{base}.{a.name}") is not None:
                        yield f"{base}.{a.name}"
            yield from visit(ast.iter_child_nodes(node))

    yield from visit(ast.parse(path.read_text()).body)


def test_chip_smoke_never_imports_prometheus_client():
    """The card's machine has no ``prometheus_client``: nothing that
    ``chip_smoke.py`` imports, within the port, imports it or the
    Prometheus sink (``metrics/prom.py``), which only ``new_metrics``
    with its default backend imports, inside the call; and
    ``metrics/prom.py`` is the only port file that imports it at all."""
    seen, external = set(), set()
    todo = [("chip_smoke", ROOT / "chip_smoke.py")]
    while todo:
        modname, path = todo.pop()
        if modname in seen:
            continue
        seen.add(modname)
        for name in _import_time_names(path, modname):
            parts = name.split(".")
            if parts[0] != "kubebrain_tpu_torch":
                external.add(parts[0])
                continue
            for i in range(1, len(parts) + 1):  # parent packages run first
                sub = ".".join(parts[:i])
                f = _module_file(sub)
                if f is not None and sub not in seen:
                    todo.append((sub, f))
    assert "kubebrain_tpu_torch.metrics" in seen  # the script's sink base
    # phase (i) boots through the CLI, whose wiring (lease included) is
    # imported inside ``build_backend``: run under blocked imports below
    assert "kubebrain_tpu_torch.sched" in seen and "kubebrain_tpu_torch.cli" in seen
    assert "kubebrain_tpu_torch.metrics.prom" not in seen
    assert "prometheus_client" not in external
    importers = sorted(str(p.relative_to(ROOT)) for p in PORT_FILES
                       if any(m.split(".")[0] == "prometheus_client"
                              for m in _imported_modules(p)))
    assert importers == ["kubebrain_tpu_torch/metrics/prom.py"]
    calls = [n for n in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text()))
             if isinstance(n, ast.Name) and n.id in ("new_metrics",
                                                      "PrometheusMetrics")]
    assert not calls


def test_chip_smoke_imports_without_prometheus_client():
    """Importing ``chip_smoke.py`` with ``prometheus_client`` made
    unimportable succeeds and loads no Prometheus sink."""
    code = ("import sys; sys.modules['prometheus_client'] = None; "
            "import chip_smoke; "
            "assert 'kubebrain_tpu_torch.metrics' in sys.modules; "
            "assert 'kubebrain_tpu_torch.metrics.prom' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


#: a meta-path finder that makes the front's and the Prometheus sink's
#: dependencies unimportable, as on the card's machine
BLOCKER = """
import sys


class Blocked:
    NAMES = ("grpc", "google.protobuf", "prometheus_client", "cryptography")

    def find_spec(self, name, path=None, target=None):
        if any(name == n or name.startswith(n + ".") for n in self.NAMES):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Blocked())
"""


def test_chip_smoke_and_build_backend_run_without_the_front_dependencies():
    """With ``grpc``, ``google.protobuf``, ``prometheus_client`` and
    ``cryptography`` unimportable, ``chip_smoke.py`` imports and
    ``cli.build_backend`` wires a Backend over ``cuda`` on memkv with the
    device fan-out, one node and a sink of its own, and serves a write
    and a Range; then it builds a ``--role follower`` backend whose role
    bootstraps through ``ReplicaApplier`` and admits reads, without
    loading the replication stream or the client: none of it reaches the
    gRPC front."""
    code = BLOCKER + """
import chip_smoke
from kubebrain_tpu_torch import cli

try:
    import grpc  # noqa: F401
except ImportError:
    pass
else:
    raise AssertionError("the blocker let grpc through")
backend, store, peers = cli.build_backend(
    ["--storage", "cuda", "--inner-storage", "memkv", "--device", "cpu",
     "--single-node", "--identity", "127.0.0.1:2380", "--tpu-fanout"],
    metrics=chip_smoke.RecordingMetrics())
try:
    rev = backend._kb_scheduler.create(b"/registry/pods/a/p", b"v")
    assert [kv.revision for kv in backend._kb_scheduler.list_(
        b"/registry/pods/", b"/registry/pods0").kvs] == [rev]
    assert peers.is_leader() and backend._kb_lease is not None
finally:
    backend.close()
    store.close()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "grpc", "google", "prometheus_client", "cryptography"))
assert not any(m.startswith(("grpc", "google.protobuf", "prometheus_client",
                             "cryptography")) for m in loaded), loaded
assert "kubebrain_tpu_torch.server.service.peer" in sys.modules
backend, store, role = cli.build_backend(
    ["--role", "follower", "--leader-address", "127.0.0.1:1",
     "--leader-info", "127.0.0.1:2", "--storage", "cuda", "--inner-storage",
     "memkv", "--device", "cpu", "--identity", "127.0.0.1:2380",
     "--tpu-fanout", "--max-staleness-ms", "5000"],
    metrics=chip_smoke.RecordingMetrics())
try:
    from kubebrain_tpu_torch.replica import ReplicaApplier
    assert type(role).__name__ == "FollowerRole" and not role.is_leader()
    ReplicaApplier(backend, role=role).apply_bootstrap([], 5)
    role.gate_read(5, False)  # an explicit revision at the watermark
    role.gate_read(0, True)   # serializable, inside the bound
finally:
    role.close()
    backend.close()
    store.close()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "grpc", "google", "prometheus_client", "cryptography"))
assert not any(m.startswith(("grpc", "google.protobuf", "prometheus_client",
                             "cryptography")) for m in loaded), loaded
assert "kubebrain_tpu_torch.replica.stream" not in sys.modules
assert "kubebrain_tpu_torch.client" not in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def test_workload_checker_and_entry_load_without_the_front_dependencies():
    """With ``grpc``, ``google.protobuf``, ``prometheus_client`` and
    ``cryptography`` unimportable, the workload harness (``workload/*``, the
    runner included), ``lincheck`` and ``entry`` import, a schedule
    generates, a runner is built and a history checks; only the runner's
    gRPC transport needs ``grpc`` and says so when it is asked for it."""
    code = BLOCKER + """
from kubebrain_tpu_torch import entry, lincheck
from kubebrain_tpu_torch.workload import (
    WorkloadSpec, clock, generator, runner, slo, spec)

spec = WorkloadSpec.for_smoke(4)
assert generator.generate(spec).sha256()
r = runner.WorkloadRunner(spec, write_report=False)
assert isinstance(r.transport, runner.GrpcTransport)
try:
    r.transport.rpc_errors
except ImportError:
    pass
else:
    raise AssertionError("the gRPC transport loaded grpc")
h = lincheck.History()
h.record(0, "create", b"k", 0.0, 1.0, value=b"v", ok=True, rev=1)
assert h.check()["ok"]
step, args = entry.entry("cpu")
assert int(step(*args)[1]) == 128
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "grpc", "google", "prometheus_client", "cryptography"))
assert not any(m.startswith(("grpc", "google.protobuf", "prometheus_client",
                             "cryptography")) for m in loaded), loaded
assert "kubebrain_tpu_torch.client" not in sys.modules
assert not any(m == "jax" or m.startswith(("jax.", "kubebrain_tpu."))
               for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
