"""The port's request-plane dispatcher (``planer_tpu_torch.parallel.
dispatcher``, a copy of the JAX package's) and multi-host bring-up
(``multihost.initialize``): the cases of tests/test_dispatcher.py, its
two-process kill-and-evict dryrun (toy workers that import no torch, each
wait bounded), a worker serving a port ``Net``, the port's health probe as
the workers' default, and ``initialize`` on a ``gloo`` world of one and
against an unreachable coordinator, each in a subprocess so that the test
process keeps no process group."""
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np

from planer_tpu.parallel import dispatcher as JD

from planer_tpu_torch import models
from planer_tpu_torch.parallel import dispatcher as D
from planer_tpu_torch.parallel import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _toy(x):
    return x.astype(np.float32) * 2.0 + 1.0


def _thread_worker(disp, host_id, net=_toy, health_fn=None):
    t = threading.Thread(
        target=D.run_worker,
        args=(disp.address, net),
        kwargs={"host_id": host_id, "health_fn": health_fn},
        daemon=True)
    t.start()
    return t


def test_requests_flow_across_dp_group():
    with D.Dispatcher(max_delay_ms=1.0, ping_interval_s=0.5,
                      ping_timeout_s=2.0) as disp:
        _thread_worker(disp, "a")
        _thread_worker(disp, "b")
        disp.wait_for_workers(2, timeout_s=10)
        x = np.arange(6, dtype=np.float32)
        for wave in range(6):  # waves -> separate batches -> round robin
            futs = [disp.submit(x + wave + i) for i in range(3)]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(f.result(timeout=10),
                                           (x + wave + i) * 2 + 1)
        st = disp.stats()
        assert st["requests"] == 18
        assert st["dp_size"] == 2
        served = [h for h, s in st["workers"].items() if s["batches"] > 0]
        assert len(served) == 2, f"round robin never reached: {st['workers']}"


def test_tuple_outputs_and_padding():
    def multi(x):
        return x * 2.0, x.sum(axis=tuple(range(1, x.ndim)))

    with D.Dispatcher(buckets=(4,), max_delay_ms=1.0) as disp:
        _thread_worker(disp, "a", net=multi)
        disp.wait_for_workers(1, timeout_s=10)
        x = np.ones((2, 2), np.float32)
        got = disp.submit(x).result(timeout=10)  # padded from 1 -> bucket 4
        assert isinstance(got, tuple)
        np.testing.assert_allclose(got[0], x * 2)
        np.testing.assert_allclose(got[1], 4.0)


def test_batch_errors_strike_out_and_retry_on_survivor():
    def bad(x):
        raise ValueError("injected failure")

    with D.Dispatcher(max_delay_ms=1.0, ping_interval_s=10,
                      max_strikes=2, retries=4) as disp:
        _thread_worker(disp, "bad", net=bad)
        disp.wait_for_workers(1, timeout_s=10)
        _thread_worker(disp, "good")
        disp.wait_for_workers(2, timeout_s=10)
        x = np.arange(3, dtype=np.float32)
        for wave in range(8):
            futs = [disp.submit(x + wave + i) for i in range(2)]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(f.result(timeout=20),
                                           (x + wave + i) * 2 + 1)
        deadline = time.monotonic() + 10
        while "bad" in disp.workers() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert disp.workers() == ["good"]
        reasons = [e["reason"] for e in disp.stats()["evictions"]]
        assert any("batch errors" in r for r in reasons)


def test_unhealthy_host_is_evicted_by_health_loop():
    def sick(deadline_s=2.0):
        return {"healthy": False, "devices": {}}

    with D.Dispatcher(max_delay_ms=1.0, ping_interval_s=0.1,
                      ping_timeout_s=1.0) as disp:
        _thread_worker(disp, "sick", health_fn=sick)
        disp.wait_for_workers(1, timeout_s=10)
        deadline = time.monotonic() + 10
        while "sick" in disp.workers() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "sick" not in disp.workers()
        reasons = [e["reason"] for e in disp.stats()["evictions"]]
        assert any("unhealthy" in r for r in reasons)


def test_two_process_dryrun_kill_and_evict():
    """Subprocess hosts (toy nets, no torch import), one killed by exact
    PID mid-stream: it is evicted and every later request completes on the
    survivor.  Each wait inside is bounded by its own timeout."""
    t0 = time.monotonic()
    report = D.dryrun(n_workers=2, n_requests=16)
    assert report["ok"], report
    assert len(report["evictions"]) == 1
    assert report["dp_size_after"] == 1
    served = [h for h, n in report["batch_spread"].items() if n > 0]
    assert len(served) == 2, report["batch_spread"]
    assert time.monotonic() - t0 < 60


def test_module_is_the_jax_package_copy():
    """The port's module keeps the JAX package's wire format and API: the
    same public names, message framing and worker bootstrap."""
    for name in ("Dispatcher", "run_worker", "dryrun", "spawn_toy_worker",
                 "_send_msg", "_recv_msg", "_LEN", "_WORKER_BOOTSTRAP"):
        assert hasattr(D, name), name
    assert D._LEN.format == JD._LEN.format
    assert D._WORKER_BOOTSTRAP == JD._WORKER_BOOTSTRAP
    a, b = socket.socketpair()
    try:
        D._send_msg(a, ("batch", 7, np.arange(3)))
        kind, bid, x = JD._recv_msg(b)
        assert (kind, bid) == ("batch", 7) and x.tolist() == [0, 1, 2]
    finally:
        a.close()
        b.close()


def test_bootstraps_by_file_path_without_torch():
    """A worker loads the module by path with torch unimportable."""
    code = ("import sys, importlib.util\n"
            "sys.modules['torch'] = None\n"
            "spec = importlib.util.spec_from_file_location('_d', sys.argv[1])\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "sys.modules['_d'] = m\n"
            "spec.loader.exec_module(m)\n"
            "assert callable(m.run_worker)\n")
    r = subprocess.run([sys.executable, "-c", code, D.__file__],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr


def test_worker_serves_a_port_net_with_the_ports_health_probe(monkeypatch):
    """``run_worker(address, net)`` with a port Net answers what the Net
    answers, and its default health probe is the port's ``health_check``:
    patched unhealthy, it gets the worker evicted."""
    net = models.resnet18(num_classes=8, device="cpu")
    xs = np.random.default_rng(4).standard_normal(
        (3, 3, 32, 32)).astype(np.float32)
    with D.Dispatcher(buckets=(1, 2, 4), max_delay_ms=1.0,
                      ping_interval_s=0.2, ping_timeout_s=5.0) as disp:
        _thread_worker(disp, "net", net=net)
        disp.wait_for_workers(1, timeout_s=10)
        outs = [f.result(timeout=60) for f in [disp.submit(x) for x in xs]]
        np.testing.assert_allclose(np.stack(outs), net(xs), rtol=1e-5,
                                   atol=1e-5)
        assert disp.workers() == ["net"]     # the port's probe: healthy
        monkeypatch.setattr(multihost, "health_check",
                            lambda deadline_s=2.0: {"healthy": False})
        _thread_worker(disp, "sick", net=net)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not disp.stats()["evictions"]:
            time.sleep(0.05)
        assert disp.workers() == ["net"]
        reasons = [e["reason"] for e in disp.stats()["evictions"]]
        assert any("unhealthy" in r for r in reasons)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run(code, timeout=60):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_initialize_forms_a_gloo_world_of_one():
    code = ("import torch.distributed as dist\n"
            "from planer_tpu_torch.parallel.multihost import initialize\n"
            f"r = initialize('127.0.0.1:{_free_port()}', 1, 0, timeout_s=30,"
            " device='cpu')\n"
            "assert r == {'process_index': 0, 'process_count': 1,"
            " 'local_devices': 1}, r\n"
            "assert dist.get_backend() == 'gloo'\n"
            "dist.destroy_process_group()\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_initialize_reads_torch_env_names():
    port = _free_port()
    code = ("import os, torch.distributed as dist\n"
            "os.environ.update(MASTER_ADDR='127.0.0.1', "
            f"MASTER_PORT='{port}', WORLD_SIZE='1', RANK='0')\n"
            "from planer_tpu_torch.parallel.multihost import initialize\n"
            "r = initialize(timeout_s=30, device='cpu')\n"
            "assert r['process_count'] == 1, r\n"
            "dist.destroy_process_group()\n"
            "print('ok')\n")
    r = _run(code)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_initialize_times_out_on_an_unreachable_coordinator():
    """Rank 1 of 2 with no rank 0 listening: TimeoutError naming the
    address within its timeout, instead of hanging; and the process exits
    soon after, its abandoned rendezvous having given up by itself."""
    addr = f"127.0.0.1:{_free_port()}"
    code = ("import time\n"
            "from planer_tpu_torch.parallel.multihost import initialize\n"
            "t0 = time.monotonic()\n"
            "try:\n"
            f"    initialize('{addr}', 2, 1, timeout_s=2, device='cpu')\n"
            "except TimeoutError as e:\n"
            f"    assert '{addr}' in str(e), e\n"
            "    print('timeout', time.monotonic() - t0, time.time())\n")
    r = _run(code)
    exited = time.time()
    assert r.returncode == 0, r.stderr
    took, raised = (float(v) for v in r.stdout.split()[-2:])
    assert took < 2.5, r.stdout
    assert exited - raised < 4.0, (exited - raised, r.stdout)
