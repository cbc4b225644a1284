"""The port's durable library cache and registry autotuning
(``flink_ml_tpu_torch/kernels/aot.py``, ``autotune.py``, and
``kernels/build.py``'s path through them) on the CPU, modelled on
``tests/test_aot_cache.py``.

This machine has no nvcc, so the artifacts are stand-ins: a one-function
C library built by the host compiler and loaded with ``ctypes``, or a
build callable that writes bytes (loaded by reading them back).  Covered:

- the round trip and its accounting (a miss builds, stores and loads; a
  new cache over the same root loads the committed entry: an aot hit);
  the in-process memo;
- the corruption sweep: a truncated, flipped, stale-fingerprint or
  unmanifested entry is quarantined and rebuilt, never loaded, and
  counted; an uncommitted tmp entry is invisible; a failed store still
  serves this process (``store_failed``); a failed build raises;
- two processes racing one key leave one committed entry, which both
  load; ``stable_repr`` / ``plan_token`` agree across processes;
- ``env_fingerprint`` is total with no card and no nvcc;
- ``build.load_library`` / ``build_all`` through a configured root;
- autotune: the winner persists and loads back with no search, disabled
  autotune measures but does not persist, a corrupt decision is searched
  again, another card's decision is skipped, ``lookup`` honours a tuned
  backend, GBT's ``"auto"`` through a decision fits the forest of the
  chosen form.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from flink_ml_tpu_torch.kernels import aot, autotune, build
from flink_ml_tpu_torch.kernels import registry as kreg
from flink_ml_tpu_torch.kernels.registry import kernel_stats
from flink_ml_tpu_torch.robustness import durability

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture
def cache(tmp_path):
    c = aot.ExecutableCache(str(tmp_path / "aotcache"))
    aot.set_cache(c)
    try:
        yield c
    finally:
        aot.reset_cache()


@pytest.fixture
def stub_c(tmp_path):
    path = tmp_path / "stub.c"
    path.write_text("int stub_answer(void) { return 42; }\n")
    return str(path)


def _cc_build(stub, calls):
    """A stand-in for nvcc: the host compiler builds ``libstub.so`` (and a
    report beside it) into the cache's tmp dir."""
    def build_fn(out_dir):
        calls.append(out_dir)
        subprocess.run(["cc", "-shared", "-fPIC", "-o",
                        os.path.join(out_dir, "libstub.so"), stub],
                       check=True, capture_output=True)
        with open(os.path.join(out_dir, "libstub.log"), "w") as f:
            f.write("stand-in build report\n")
        return "libstub.so"
    return build_fn


def _bytes_build(payload, calls):
    def build_fn(out_dir):
        calls.append(out_dir)
        with open(os.path.join(out_dir, "lib.bin"), "wb") as f:
            f.write(payload)
        return "lib.bin"
    return build_fn


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _aot():
    return kernel_stats.snapshot()["aot"]


def _entries(cache):
    root = os.path.join(cache.root, "exec")
    return sorted(os.path.join(root, n) for n in os.listdir(root)
                  if ".corrupt" not in n and ".tmp." not in n)


# ---------------------------------------------------------------------------
# round trip, accounting, memo
# ---------------------------------------------------------------------------

def test_roundtrip_builds_stores_then_loads_and_is_accounted(cache, stub_c):
    calls = []
    key = cache.key_for("library", "stub", "source-hash-1")
    a0 = _aot()
    lib, source = cache.load_or_build(key, _cc_build(stub_c, calls),
                                      label="stub")
    a1 = _aot()
    assert source == "compile" and len(calls) == 1
    assert lib.stub_answer() == 42
    assert a1["misses"] == a0["misses"] + 1
    assert a1["stores"] == a0["stores"] + 1
    assert a1["compile_ms"] > a0["compile_ms"]
    (entry,) = _entries(cache)
    assert sorted(os.listdir(entry)) == [
        "COMMITTED", "libstub.log", "libstub.so", "manifest.json",
        "meta.json"]
    durability.verify_dir(entry, allow_legacy=False)
    with open(os.path.join(entry, "meta.json")) as f:
        meta = json.load(f)
    assert meta["fingerprint"] == aot.env_fingerprint()
    assert meta["payload"] == "libstub.so" and meta["key"] == key
    # a new cache over the same root: what a restarted process sees
    again = aot.ExecutableCache(cache.root)
    lib2, source2 = again.load_or_build(key, _cc_build(stub_c, calls),
                                        label="stub")
    a2 = _aot()
    assert source2 == "aot" and len(calls) == 1
    assert lib2.stub_answer() == 42
    assert a2["hits"] == a1["hits"] + 1 and a2["misses"] == a1["misses"]
    assert a2["load_ms"] > a1["load_ms"]


def test_memory_memo_skips_disk_after_first_load(cache):
    calls = []
    key = cache.key_for("library", "memo", "h")
    got, src = cache.load_or_build(key, _bytes_build(b"abc", calls),
                                   load=_read)
    assert (got, src) == (b"abc", "compile")
    for entry in _entries(cache):      # the disk goes away: the memo serves
        os.rename(entry, entry + ".moved")
    assert cache.load_or_build(key, _bytes_build(b"zzz", calls),
                               load=_read) == (b"abc", "memory")
    cache.forget_loaded()
    got, src = cache.load_or_build(key, _bytes_build(b"xyz", calls),
                                   load=_read)
    assert (got, src) == (b"xyz", "compile") and len(calls) == 2


def test_keys_change_with_source_and_environment(cache):
    k1 = cache.key_for("library", "stub", "hash-a")
    assert k1 == cache.key_for("library", "stub", "hash-a")
    assert k1 != cache.key_for("library", "stub", "hash-b")
    assert k1 != cache.key_for("library", "other", "hash-a")
    fp = aot.env_fingerprint()
    assert k1 == aot._digest("library", "stub", "hash-a", fp)
    assert k1 != aot._digest("library", "stub", "hash-a",
                             dict(fp, nvcc="Cuda compilation tools, "
                                           "release 0.0"))
    assert k1 != aot._digest("library", "stub", "hash-a",
                             dict(fp, device="another card"))


# ---------------------------------------------------------------------------
# the corruption sweep
# ---------------------------------------------------------------------------

def _truncate(entry):
    path = os.path.join(entry, "lib.bin")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _flip(entry):
    path = os.path.join(entry, "lib.bin")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def _stale_fingerprint(entry):
    # a skewed entry whose CRCs are valid: meta claims another nvcc, the
    # manifest and marker committed again over the edit
    meta_path = os.path.join(entry, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["fingerprint"]["nvcc"] = "release 0.0 (stale)"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    durability.write_manifest(entry)
    durability.write_commit_marker(entry)


def _drop_manifest(entry):
    os.remove(os.path.join(entry, "manifest.json"))


@pytest.mark.parametrize("damage", [_truncate, _flip, _stale_fingerprint,
                                    _drop_manifest],
                         ids=["truncated", "flipped-byte",
                              "stale-fingerprint", "missing-manifest"])
def test_damaged_entry_is_quarantined_and_rebuilt_never_loaded(cache,
                                                                damage):
    calls, loaded = [], []

    def load(path):
        loaded.append(_read(path))
        return loaded[-1]

    payload = bytes(range(256)) * 16
    key = cache.key_for("library", "swept", "h")
    cache.load_or_build(key, _bytes_build(payload, calls), load=load)
    (entry,) = _entries(cache)
    damage(entry)
    loaded.clear()

    fresh = aot.ExecutableCache(cache.root)       # a restarted process
    before = _aot()
    got, source = fresh.load_or_build(key, _bytes_build(payload, calls),
                                      load=load)
    after = _aot()
    assert source == "compile" and len(calls) == 2     # rebuilt
    assert loaded == [payload] and got == payload      # the damage never
    assert after["quarantined"] == before["quarantined"] + 1   # loaded
    assert after["misses"] == before["misses"] + 1
    corrupt = [n for n in os.listdir(os.path.join(cache.root, "exec"))
               if ".corrupt" in n]
    assert len(corrupt) == 1
    # the rebuild was stored: the next restart loads it
    third = aot.ExecutableCache(cache.root)
    assert third.load_or_build(key, _bytes_build(b"no", calls),
                               load=load) == (payload, "aot")
    assert _aot()["hits"] == after["hits"] + 1 and len(calls) == 2


def test_valid_bytes_the_loader_refuses_are_quarantined(cache, stub_c):
    """A committed entry whose library ``ctypes`` cannot load (valid CRCs,
    junk bytes) is quarantined and rebuilt, not raised."""
    calls = []
    key = cache.key_for("library", "junk", "h")
    tmp = cache.begin_entry(key)
    with open(os.path.join(tmp, "libstub.so"), "wb") as f:
        f.write(b"not an ELF object")
    cache.commit_entry(key, tmp, "libstub.so", label="junk")
    before = _aot()
    lib, source = aot.ExecutableCache(cache.root).load_or_build(
        key, _cc_build(stub_c, calls), label="junk")
    assert source == "compile" and lib.stub_answer() == 42
    assert _aot()["quarantined"] == before["quarantined"] + 1


def test_uncommitted_tmp_entry_is_invisible(cache):
    calls = []
    key = cache.key_for("library", "tmp", "h")
    cache.load_or_build(key, _bytes_build(b"one", calls), load=_read)
    (entry,) = _entries(cache)
    os.rename(entry, entry + ".tmp.999")          # never committed
    before = _aot()
    got, source = aot.ExecutableCache(cache.root).load_or_build(
        key, _bytes_build(b"two", calls), load=_read)
    after = _aot()
    assert (got, source) == (b"two", "compile")
    assert after["quarantined"] == before["quarantined"]
    assert after["misses"] == before["misses"] + 1


def test_store_failure_still_serves_this_process(cache, monkeypatch):
    def broken_commit(dirpath, **kw):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(durability, "commit_dir", broken_commit)
    calls = []
    key = cache.key_for("library", "nospace", "h")
    before = _aot()
    got, source = cache.load_or_build(key, _bytes_build(b"built", calls),
                                      load=_read)
    after = _aot()
    assert (got, source) == (b"built", "compile")
    assert after["store_failed"] == before["store_failed"] + 1
    assert after["stores"] == before["stores"]
    assert os.listdir(os.path.join(cache.root, "exec")) == []  # no debris
    assert cache.load_or_build(key, _bytes_build(b"x", calls),
                               load=_read) == (b"built", "memory")


def test_failed_build_raises_and_commits_nothing(cache):
    def failing(out_dir):
        raise RuntimeError("kernel build failed: nvcc exited 1")

    key = cache.key_for("library", "broken", "h")
    with pytest.raises(RuntimeError, match="nvcc exited 1"):
        cache.load_or_build(key, failing, load=_read)
    assert os.listdir(os.path.join(cache.root, "exec")) == []


# ---------------------------------------------------------------------------
# kernels/build.py through a configured root
# ---------------------------------------------------------------------------

def _stand_in_nvcc(stub, started, fail=()):
    def start(name, out_dir):
        started.append(name)
        src = "int bad(" if name in fail else None
        cmd = ["cc", "-shared", "-fPIC", "-o",
               os.path.join(out_dir, f"lib{name}.so")]
        if src is None:
            cmd.append(stub)
        else:
            cmd += ["-x", "c", "-"]
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE if src else None,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        if src:
            proc.stdin.write(src)
            proc.stdin.close()
            proc.stdin = None
        return proc
    return start


def test_build_goes_through_the_configured_root(cache, stub_c, monkeypatch):
    started = []
    monkeypatch.setattr(build, "_start_nvcc", _stand_in_nvcc(stub_c,
                                                             started))
    monkeypatch.setattr(build, "_LOADED", {})
    assert build.library_cache() is cache
    names = ["ell_scatter", "emb_grad"]
    build.build_all(names)
    assert sorted(started) == names                # both at once
    for name in names:
        target = build._target(name)
        assert target.startswith(os.path.join(cache.root, "exec"))
        assert os.path.isfile(target)
        assert build.build_log(name) is not None
    build.build_all(names)                         # nothing stale
    assert sorted(started) == names
    before = _aot()
    lib = build.load_library("ell_scatter")        # the committed entry
    assert lib.stub_answer() == 42 and sorted(started) == names
    assert _aot()["hits"] == before["hits"] + 1
    assert build.load_library("ell_scatter") is lib


def test_build_failure_raises_with_the_report(cache, stub_c, monkeypatch):
    started = []
    monkeypatch.setattr(build, "_start_nvcc",
                        _stand_in_nvcc(stub_c, started, fail=("kmeans",)))
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="kernel build failed"):
        build.build_all(["kmeans", "retrieve"])
    with pytest.raises(RuntimeError, match="kernel build failed"):
        build.load_library("kmeans")
    assert not os.path.exists(build._target("kmeans"))
    assert os.path.isfile(build._target("retrieve"))
    assert not [n for n in os.listdir(os.path.join(cache.root, "exec"))
                if ".tmp." in n]


def test_default_root_is_the_build_dir(tmp_path, monkeypatch):
    aot.set_cache(None)
    try:
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
        c = build.library_cache()
        assert c.root == str(tmp_path / "b") and build.library_cache() is c
        assert not autotune.enabled()
    finally:
        aot.reset_cache()


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------

_RACER = textwrap.dedent("""\
    import json, os, sys, time
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.kernels import aot
    from flink_ml_tpu_torch.kernels.registry import kernel_stats
    from flink_ml_tpu_torch.models.clustering.kmeans import (
        _kmeans_chain_kernel)

    root, go = sys.argv[1], sys.argv[2]
    cache = aot.ExecutableCache(root)
    key = cache.key_for("library", "raced", "h")
    while not os.path.exists(go):
        time.sleep(0.005)

    def build(out_dir):
        time.sleep(0.3)
        with open(os.path.join(out_dir, "lib.bin"), "w") as f:
            f.write(str(os.getpid()))
        return "lib.bin"

    def load(path):
        with open(path) as f:
            return f.read()

    got, source = cache.load_or_build(key, build, load=load)
    plan = ((_kmeans_chain_kernel,
             ("f", "a", DistanceMeasure.get_instance("euclidean"))),)
    print(json.dumps({"got": got, "source": source,
                      "aot": kernel_stats.snapshot()["aot"],
                      "token": aot.plan_token(plan),
                      "repr": aot.stable_repr(
                          {"m": DistanceMeasure.get_instance("cosine"),
                           "t": (1, 2.5, "x")})}))
""")


def test_two_processes_racing_one_key_commit_one_entry(tmp_path):
    from flink_ml_tpu_torch.distance import DistanceMeasure
    from flink_ml_tpu_torch.models.clustering.kmeans import (
        _kmeans_chain_kernel)

    script = tmp_path / "racer.py"
    script.write_text(_RACER)
    root, go = str(tmp_path / "shared"), str(tmp_path / "go")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), root, go],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    deadline = time.monotonic() + 120
    while not os.path.isdir(os.path.join(root, "exec")) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    time.sleep(0.5)              # both past their imports
    open(go, "w").close()
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    committed = [n for n in os.listdir(os.path.join(root, "exec"))]
    assert len(committed) == 1, committed          # one entry, no debris
    winner = _read(os.path.join(root, "exec", committed[0], "lib.bin"))
    assert all(o["got"] == winner.decode() for o in outs)
    assert sum(o["aot"]["stores"] for o in outs) == 1
    assert all(o["aot"]["store_failed"] == 0 for o in outs)
    assert all(o["aot"]["quarantined"] == 0 for o in outs)
    # stable_repr / plan_token: the same in both processes and this one
    plan = ((_kmeans_chain_kernel,
             ("f", "a", DistanceMeasure.get_instance("euclidean"))),)
    assert outs[0]["token"] == outs[1]["token"] == aot.plan_token(plan)
    assert " at 0x" not in outs[0]["token"]
    want = aot.stable_repr({"m": DistanceMeasure.get_instance("cosine"),
                            "t": (1, 2.5, "x")})
    assert outs[0]["repr"] == outs[1]["repr"] == want


def test_env_fingerprint_is_total_without_a_card_or_nvcc(monkeypatch):
    import torch

    fp = aot.env_fingerprint()
    assert set(fp) == {"torch", "cuda", "nvcc", "device", "capability",
                       "format"}
    assert fp["torch"] == torch.__version__
    assert fp["cuda"] == torch.version.cuda
    assert fp["format"] == aot.AOT_FORMAT
    if not torch.cuda.is_available():
        assert fp["device"] is None and fp["capability"] is None
    assert aot.env_fingerprint() == fp             # memoised

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    assert aot._nvcc_release() is None
    monkeypatch.setattr(aot, "_FINGERPRINT", [])
    fresh = aot.env_fingerprint()
    assert fresh["nvcc"] is None and fresh["torch"] == fp["torch"]


def test_aot_jit_calls_straight_through():
    def f(x, *, scale=2):
        return x * scale

    wrapped = aot.aot_jit(f)
    assert wrapped.__wrapped__ is f and wrapped(3) == 6
    deco = aot.aot_jit(static_argnames=("scale",), donate_argnums=(0,))(f)
    assert deco.__wrapped__ is f and deco(3, scale=5) == 15
    assert aot._code_fingerprint(wrapped) == aot._code_fingerprint(f)


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

def _timed(calls, name, delay):
    def thunk():
        calls[name] += 1
        time.sleep(delay)
        return np.zeros(1)
    return thunk


def test_autotune_winner_persists_and_loads_back(cache):
    calls = {"slow": 0, "fast": 0}
    choice, decision = autotune.choose(
        "aot_test_op", (16, 4),
        {"slow": _timed(calls, "slow", 0.003),
         "fast": _timed(calls, "fast", 0.0)})
    assert choice == "fast" and decision["search_ms"] > 0
    assert calls["slow"] > 0 and calls["fast"] > 0
    assert decision["device"] == {"device": aot.env_fingerprint()["device"]}
    key = "aot_test_op|(16, 4)"
    assert kernel_stats.tuned_ops[key]["source"] == "measured"
    aot.set_cache(aot.ExecutableCache(cache.root))     # a later process
    calls.update(slow=0, fast=0)
    choice2, _ = autotune.choose(
        "aot_test_op", (16, 4),
        {"slow": _timed(calls, "slow", 0.003),
         "fast": _timed(calls, "fast", 0.0)})
    assert choice2 == "fast" and calls == {"slow": 0, "fast": 0}
    assert kernel_stats.tuned_ops[key]["source"] == "cache"
    assert kernel_stats.tuned_ops[key]["search_ms"] == 0.0
    assert autotune.decided_choice("aot_test_op", (16, 4)) == "fast"
    assert autotune.decided_backend("aot_test_op", (16, 4)) == "fast"


def test_autotune_disabled_measures_but_does_not_persist():
    aot.set_cache(None)
    try:
        assert not autotune.enabled()
        calls = {"a": 0, "b": 0}
        choice, dec = autotune.choose(
            "aot_nopersist_op", (),
            {"a": _timed(calls, "a", 0.0), "b": _timed(calls, "b", 0.003)})
        assert choice == "a" and dec["device"] is None
        assert calls["a"] > 0 and calls["b"] > 0
        assert autotune.get_decision("aot_nopersist_op", ()) is None
    finally:
        aot.reset_cache()


def test_corrupt_decision_is_quarantined_and_searched_again(cache):
    calls = {"x": 0, "y": 0}
    cands = {"x": _timed(calls, "x", 0.0), "y": _timed(calls, "y", 0.0)}
    autotune.choose("aot_decay_op", (), cands)
    tune_root = os.path.join(cache.root, "autotune")
    (entry,) = [os.path.join(tune_root, n) for n in os.listdir(tune_root)]
    os.remove(os.path.join(entry, "manifest.json"))
    aot.set_cache(aot.ExecutableCache(cache.root))
    before = _aot()["quarantined"]
    assert autotune.get_decision("aot_decay_op", ()) is None
    assert any(".corrupt" in n for n in os.listdir(tune_root))
    assert _aot()["quarantined"] == before + 1
    calls.update(x=0, y=0)
    autotune.choose("aot_decay_op", (), cands)           # searched again
    assert calls["x"] > 0 and calls["y"] > 0
    assert kernel_stats.tuned_ops["aot_decay_op|()"]["source"] == "measured"


def test_foreign_device_decision_is_skipped_not_quarantined(cache):
    cache.record_decision({
        "format": 1, "op": "aot_foreign_op", "sig": "()", "kind": "backend",
        "choice": "x", "timings_ms": {}, "search_ms": 1.0, "probe": "",
        "device": {"device": "a mythical card"}})
    aot.set_cache(aot.ExecutableCache(cache.root))       # a fresh scan
    assert autotune.get_decision("aot_foreign_op", ()) is None
    tune_root = os.path.join(cache.root, "autotune")
    assert not any(".corrupt" in n for n in os.listdir(tune_root))
    assert len(os.listdir(tune_root)) == 1               # it survived


def test_lookup_honours_a_tuned_backend(cache):
    kreg.register_kernel("aot_lookup_op", "alpha", lambda: None,
                         priority=10)
    kreg.register_kernel("aot_lookup_op", "beta", lambda: None,
                         priority=0)
    try:
        assert kreg.lookup("aot_lookup_op").backend == "alpha"
        choice, _ = autotune.choose(
            "aot_lookup_op", (),
            {"alpha": lambda: (time.sleep(0.003), np.zeros(1))[1],
             "beta": lambda: np.zeros(1)})
        assert choice == "beta"
        assert kreg.lookup("aot_lookup_op").backend == "beta"
        aot.set_cache(aot.ExecutableCache(cache.root))
        assert kreg.lookup("aot_lookup_op").backend == "beta"
        assert kreg.lookup("aot_lookup_op",
                           backend="alpha").backend == "alpha"
    finally:
        with kreg._REG_LOCK:
            kreg._REGISTRY.pop("aot_lookup_op", None)


def _gbt_fit():
    from flink_ml_tpu_torch.models.common import gbt

    rng = np.random.default_rng(21)
    X = rng.normal(size=(300, 5))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)

    def grad_hess(yy, pred):
        p = 1.0 / (1.0 + np.exp(-pred))
        return p - yy, p * (1.0 - p)

    return gbt.train_forest(X, y, grad_hess, 0.0,
                            gbt.GBTConfig(num_trees=3, max_depth=3,
                                          max_bins=16), device="cpu")


def _same_forest(a, b):
    for f in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_gbt_auto_through_a_decision_fits_the_chosen_forest(cache,
                                                            monkeypatch):
    from flink_ml_tpu_torch.models.common import gbt

    # a recorded "segsum" decision: "auto" resolves to it, no search
    cache.record_decision({
        "format": 1, "op": "gbt_level_histograms", "sig": "()",
        "kind": "backend", "choice": "segsum", "timings_ms": {},
        "search_ms": 1.0, "probe": "planted",
        "device": cache._device()})
    auto = _gbt_fit()
    tuned = kernel_stats.tuned_ops["gbt_level_histograms|()"]
    assert tuned["source"] == "cache" and tuned["search_ms"] == 0.0
    assert gbt.resolve_hist_impl("auto") == "segsum"
    monkeypatch.setattr(gbt, "HIST_IMPL", "segsum")
    _same_forest(auto, _gbt_fit())
    monkeypatch.setattr(gbt, "HIST_IMPL", "auto")
    # a fresh root: the first fit measures both forms and records the
    # winner; a second fit reloads it with no search, the same forest,
    # which is the forced form's forest
    aot.set_cache(aot.ExecutableCache(cache.root + "-2"))
    first = _gbt_fit()
    tuned = dict(kernel_stats.tuned_ops["gbt_level_histograms|()"])
    assert tuned["source"] == "measured"
    assert set(tuned["timings_ms"]) == {"segsum", "mxu"}
    won = gbt.resolve_hist_impl("auto")
    assert won == tuned["choice"]
    aot.set_cache(aot.ExecutableCache(cache.root + "-2"))
    second = _gbt_fit()
    again = kernel_stats.tuned_ops["gbt_level_histograms|()"]
    assert again["source"] == "cache" and again["search_ms"] == 0.0
    _same_forest(first, second)
    monkeypatch.setattr(gbt, "HIST_IMPL", won)
    _same_forest(first, _gbt_fit())


def test_no_cache_root_means_no_search():
    from flink_ml_tpu_torch.models.common import gbt

    aot.set_cache(None)
    try:
        kernel_stats.tuned_ops.pop("gbt_level_histograms|()", None)
        _gbt_fit()
        assert "gbt_level_histograms|()" not in kernel_stats.tuned_ops
        assert gbt.resolve_hist_impl("auto") == "segsum"
    finally:
        aot.reset_cache()
