"""The port's fault harness and recovery policies
(``mpi_k_selection_tpu_torch/faults/``, the descent's recovery ladder in
``streaming/chunked.py``) against the JAX package's (tests/test_faults.py).

The same seeded chunks, under the same plans, go through both packages:
seeded plans equal spec for spec, the policies' arithmetic and messages
equal, and across the chaos grid (devices x pipeline_depth x spill) the
recovered answers equal the fault-free call's and the JAX package's bit
for bit, with ``injector.fired`` and the FaultEvent streams equal entry for
entry. Two things of an event's ``error`` text are normalized before that
comparison: a record's path (each package has its own store), and the
detail of a truncated payload, which the port reports from its heap read
and the JAX package from its default memory-mapped read.

Every store a test makes is rooted in its ``tmp_path``, and each test
checks that the root holds no ``ksel-spill-*`` directory afterwards; after
a recovered run and after an exhausted one, no ``ksel-pipeline-*`` thread
is alive and no staged chunk is still booked. Backoff runs through a
``VirtualSleeper``. The JAX package is imported inside the tests, so the
``gpu`` twin collects where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_faults.py -m gpu
"""

from __future__ import annotations

import glob
import os
import re
import threading
import warnings

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch import faults
from mpi_k_selection_tpu_torch import obs as obs_lib
from mpi_k_selection_tpu_torch.errors import (
    RetryExhaustedError,
    SpillCapacityError,
    SpillRecordError,
    TransientError,
)
from mpi_k_selection_tpu_torch.obs.ledger import LEDGER
from mpi_k_selection_tpu_torch.streaming import chunked
from mpi_k_selection_tpu_torch.streaming import executor as ex
from mpi_k_selection_tpu_torch.streaming import pipeline as pl
from test_torch_streaming import cuda_device  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _chunks(sizes=(5000, 4096, 2048, 4096, 1024), dtype=np.int32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-(2**31), 2**31 - 1, size=m, dtype=np.int64).astype(dtype) for m in sizes]


CHUNKS = _chunks()
X = np.concatenate(CHUNKS)
K = X.size // 2
WANT = int(np.sort(X, kind="stable")[K - 1])
KW = dict(radix_bits=4, collect_budget=64)


def _jax():
    """The JAX package's faults, obs and streamed entry points."""
    from mpi_k_selection_tpu import faults as jf
    from mpi_k_selection_tpu import obs as jobs
    from mpi_k_selection_tpu.streaming import chunked as jck

    return jf, jobs, jck


def _pkg(name):
    """``(faults, obs, kselect_many, kselect, certificate)`` of a package;
    the port's entry points on the CPU."""
    if name == "torch":
        return (faults, obs_lib, lambda *a, **kw: kt.kselect_streaming_many(*a, device="cpu", **kw),
                lambda *a, **kw: kt.kselect_streaming(*a, device="cpu", **kw),
                lambda *a, **kw: kt.streaming_rank_certificate(*a, device="cpu", **kw))
    jf, jobs, jck = _jax()
    return jf, jobs, jck.streaming_kselect_many, jck.streaming_kselect, jck.streaming_rank_certificate


def _policy(f, **kw):
    kw.setdefault("sleeper", f.VirtualSleeper())
    return f.RetryPolicy(**kw)


def _norm(text: str) -> str:
    text = re.sub(r"/\S*?\.kspill", "<record>", text)
    return re.sub(r"truncated payload \(.*\)", "truncated payload (...)", text)


def _fault_stream(o) -> list:
    out = []
    for e in o.events.of_kind("fault"):
        d = e.as_dict()
        d["error"] = _norm(d["error"])
        out.append(d)
    return out


def _outcome(fn):
    """A call's answer, or its exception's type and (normalized) message."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, _norm(str(e))


def _pipeline_threads() -> list:
    return [t.name for t in threading.enumerate() if t.name.startswith("ksel-pipeline")]


def _spill_dirs(root) -> list:
    return glob.glob(os.path.join(str(root), "ksel-spill-*"))


def _booked() -> dict:
    """The staged bytes the ledger books, by device (slots at 0 left out)."""
    return {k: v for k, v in LEDGER.device_bytes("staging").items() if v}


def _assert_clean(root, staged_before):
    """No producer thread, spill store or booked staged chunk left."""
    assert _pipeline_threads() == []
    assert _spill_dirs(root) == []
    assert _booked() == staged_before


def _run_both(tmp_path, plan_of, call, *, obs=True):
    """``call(pkg, src_of, spill_dir, obs)`` in both packages under their
    plan (``plan_of(faults_module)``): ``[(outcome, fired, fault events)]``
    for the port, then the JAX package. ``src_of(chunks)`` arms a chunk
    list with the plan's ``"source"`` specs."""
    out = []
    for name in ("torch", "jax"):
        p = _pkg(name)
        f, ob = p[0], p[1]
        o = ob.Observability.collecting() if obs else None
        root = tmp_path / name
        root.mkdir(exist_ok=True)
        with f.inject(plan_of(f), sleeper=f.VirtualSleeper(), obs=o) as inj:
            res = _outcome(lambda: call(p, lambda cs: inj.wrap_chunk_source(lambda: iter(cs)), str(root), o))
        out.append((res, list(inj.fired), _fault_stream(o) if obs else None))
        assert _spill_dirs(root) == []
    return out


# ---------------------------------------------------------------------------
# the harness's units against the JAX package's


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_chunks=6, faults=5),
    dict(sites=("source", "stage", "spill.write", "spill.read"), faults=7, n_chunks=64),
    dict(recoverable=False, stall_seconds=0.25),
    dict(sites=("stage",), recoverable=False, n_chunks=16),
])
def test_seeded_plans_match_jax(kw):
    jf = _jax()[0]
    for seed in range(32):
        mine, theirs = faults.FaultPlan.seeded(seed, **kw), jf.FaultPlan.seeded(seed, **kw)
        assert mine.seed == theirs.seed == seed
        assert [(s.site, s.index, s.kind, s.attempts, s.arg) for s in mine.specs] == [
            (s.site, s.index, s.kind, s.attempts, s.arg) for s in theirs.specs]
    a = faults.FaultPlan.seeded(42, n_chunks=6, faults=5)
    assert a == faults.FaultPlan.seeded(42, n_chunks=6, faults=5) and a != faults.FaultPlan.seeded(43, n_chunks=6,
                                                                                                   faults=5)
    hard = faults.FaultPlan.seeded(1, recoverable=False)
    assert all(s.attempts == (0,) if s.kind == "stall" else len(s.attempts) > 10 for s in hard.specs)
    assert (faults.FAULT_KINDS, faults.FAULT_SITES) == (jf.FAULT_KINDS, jf.FAULT_SITES)
    from mpi_k_selection_tpu.faults import plan as jplan

    from mpi_k_selection_tpu_torch.faults import plan

    assert plan._SITE_KINDS == jplan._SITE_KINDS


@pytest.mark.parametrize("bad", [
    dict(site="nope", index=0, kind="raise"),
    dict(site="source", index=0, kind="nope"),
    dict(site="source", index=0, kind="enospc"),
    dict(site="spill.write", index=0, kind="corrupt"),
    dict(site="source", index=-1, kind="raise"),
    dict(site="source", index=0, kind="raise", attempts=()),
    dict(site="source", index=0, kind="raise", attempts=(-1,)),
    "plan",
])
def test_spec_validation_messages_match_jax(bad):
    jf = _jax()[0]
    got = []
    for f in (faults, jf):
        with pytest.raises(ValueError) as ei:
            if bad == "plan":
                f.FaultPlan(specs=("not a spec",))
            else:
                f.FaultSpec(**bad)
        got.append(str(ei.value))
    assert got[0] == got[1]


def test_sleepers_and_policy_arithmetic_match_jax():
    jf = _jax()[0]
    for f in (faults, jf):
        vs = f.VirtualSleeper()
        vs.sleep(1000.0)  # a real sleeper would hang here
        vs.sleep(0.5)
        assert vs.slept == [1000.0, 0.5] and vs.total == 1000.5
        assert f.resolve_sleeper(None) is f.DEFAULT_SLEEPER and f.resolve_sleeper(vs) is vs
        p = f.RetryPolicy(backoff_base=0.1, backoff_max=0.35)
        assert [p.backoff(r) for r in (1, 2, 3, 10)] == pytest.approx([0.1, 0.2, 0.35, 0.35])
        assert f.resolve_retry(None) is f.DEFAULT_RETRY and f.resolve_retry("default") is f.DEFAULT_RETRY
        assert f.resolve_retry("off") is None and f.resolve_retry(False) is None
        mine = _policy(f)
        assert f.resolve_retry(mine) is mine
    assert faults.DEFAULT_RETRY.max_attempts == jf.DEFAULT_RETRY.max_attempts == 3
    assert (faults.DEFAULT_RETRY.backoff_base, faults.DEFAULT_RETRY.backoff_max) == (
        jf.DEFAULT_RETRY.backoff_base, jf.DEFAULT_RETRY.backoff_max)
    assert [c.__name__ for c in faults.DEFAULT_RETRYABLE] == [c.__name__ for c in jf.DEFAULT_RETRYABLE]
    assert faults.DEFAULT_RETRYABLE[1:] == (ConnectionError, TimeoutError)
    for bad in (lambda f: f.resolve_sleeper(42), lambda f: f.resolve_retry("sometimes"),
                lambda f: f.RetryPolicy(max_attempts=0), lambda f: f.RetryPolicy(backoff_base=-1)):
        assert _outcome(lambda: bad(faults)) == _outcome(lambda: bad(jf))
    for mine, theirs in ((faults.TransientError, jf.TransientError),
                         (faults.RetryExhaustedError, jf.RetryExhaustedError),
                         (faults.SpillCapacityError, jf.SpillCapacityError)):
        assert [c.__name__ for c in mine.__mro__] == [c.__name__ for c in theirs.__mro__]
    assert sorted(faults.__all__) == sorted(jf.__all__)


def test_retry_call_recovers_exhausts_and_passes_logic_errors_through():
    jf = _jax()[0]
    seen = []
    for f in (faults, jf):
        vs = f.VirtualSleeper()
        p = f.RetryPolicy(max_attempts=3, backoff_base=0.25, sleeper=vs)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise f.TransientError("blip")
            return "ok"

        assert f.retry_call(flaky, p, site="t") == "ok" and vs.slept == [0.25, 0.5]

        def always():
            raise ConnectionError("down")

        with pytest.raises(f.RetryExhaustedError) as ei:
            f.retry_call(always, p, site="t")
        assert (ei.value.site, ei.value.attempts) == ("t", 3) and isinstance(ei.value.__cause__, ConnectionError)
        with pytest.raises(ValueError, match="logic bug"):
            f.retry_call(lambda: (_ for _ in ()).throw(ValueError("logic bug")), p, site="t")
        assert f.retry_call(lambda: 7, None, site="t") == 7
        seen.append(str(ei.value))
    assert seen[0] == seen[1]


def test_inject_lifecycle_nesting_and_stall():
    jf = _jax()[0]
    for f in (faults, jf):
        plan = f.FaultPlan()
        assert f.active_injector() is None
        with f.inject(plan) as inj:
            assert f.active_injector() is inj
            with pytest.raises(RuntimeError, match="already active"):
                with f.inject(plan):
                    pass  # pragma: no cover
        assert f.active_injector() is None
        with pytest.raises(KeyError):
            with f.inject(plan):
                raise KeyError("x")
        assert f.active_injector() is None
        built = f.FaultInjector(plan)
        with pytest.raises(ValueError, match="pre-built injector"):
            with f.inject(built, sleeper=f.VirtualSleeper()):
                pass  # pragma: no cover
        with f.inject(built) as armed:
            assert armed is built
        assert f.maybe_fault("source", 0) is None  # nothing armed: nothing fires
        vs = f.VirtualSleeper()
        inj = f.FaultInjector(f.FaultPlan((f.FaultSpec("source", 0, "stall", arg=0.7),)), sleeper=vs)
        assert inj.maybe_fault("source", 0) is not None and vs.slept == [0.7]
        assert inj.maybe_fault("source", 0) is None
        assert inj.fired == [{"site": "source", "kind": "stall", "index": 0, "attempt": 0}]
        auto = f.FaultInjector(f.FaultPlan((f.FaultSpec("spill.write", 1, "enospc"),)))
        assert auto.check("spill.write") is None and auto.check("spill.write").kind == "enospc"
        with pytest.raises(ValueError, match="FaultPlan"):
            f.FaultInjector("not a plan")


def test_disk_faults_damage_the_file(tmp_path):
    for kind in ("corrupt_disk", "truncate"):
        path = tmp_path / kind
        path.write_bytes(bytes(range(200)))
        faults.apply_disk_fault(str(path), kind)
        data = path.read_bytes()
        assert (len(data), data[-1]) == ((200, 199 ^ 0xFF) if kind == "corrupt_disk" else (100, 99))


# ---------------------------------------------------------------------------
# resilient_source


def _drifting(f):
    state = {"calls": 0}

    def src():
        state["calls"] += 1
        if state["calls"] == 1:
            yield CHUNKS[0]
            yield CHUNKS[1]
            raise f.TransientError("blip")
        yield CHUNKS[0]  # the re-pull holds fewer chunks than were consumed

    return src


@pytest.mark.parametrize("case", ["repull", "exhausts", "non-retryable", "shrunken", "per-incident"])
def test_resilient_source_matches_jax(case):
    jf = _jax()[0]
    got = []
    for f in (faults, jf):
        vs = f.VirtualSleeper()
        if case == "repull":
            plan, p = f.FaultPlan((f.FaultSpec("source", 2, "raise"),)), f.RetryPolicy(sleeper=vs)
        elif case == "exhausts":
            plan, p = f.FaultPlan((f.FaultSpec("source", 1, "raise", attempts=tuple(range(99))),)), _policy(f)
        elif case == "per-incident":
            plan = f.FaultPlan(tuple(f.FaultSpec("source", i, "raise") for i in (0, 2, 4)))
            p = f.RetryPolicy(max_attempts=2, sleeper=vs)
        else:
            plan, p = f.FaultPlan(), _policy(f)
        with f.inject(plan) as inj:
            if case == "non-retryable":
                def bad():
                    yield CHUNKS[0]
                    raise KeyError("not transient")

                src = f.resilient_source(lambda: bad(), p)
            elif case == "shrunken":
                src = f.resilient_source(_drifting(f), p)
            else:
                src = f.resilient_source(inj.wrap_chunk_source(lambda: iter(CHUNKS)), p)
            res = _outcome(lambda: list(src()))
        if res[0] == "ok":
            assert len(res[1]) == len(CHUNKS) and all(np.array_equal(a, b) for a, b in zip(res[1], CHUNKS))
            res = ("ok", len(res[1]))
        got.append((res, inj.fired, vs.slept))
    assert got[0] == got[1]
    if case == "exhausts":
        assert got[0][0][0] == "RetryExhaustedError"
    if case == "per-incident":
        assert len(got[0][1]) == 3 and got[0][0] == ("ok", len(CHUNKS))
    assert {"repull": ("ok", 5), "non-retryable": ("KeyError", "'not transient'")}.get(case, got[0][0]) == got[0][0]
    assert faults.resilient_source(CHUNKS, None) is CHUNKS


# ---------------------------------------------------------------------------
# the seeded chaos grid: recovered == fault-free == the JAX package's bits


@pytest.mark.parametrize("seed", [2, 11, 37])
@pytest.mark.parametrize("devices", [None, 2])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("spill", [None, "force"])
def test_chaos_grid_matches_jax(tmp_path, seed, devices, depth, spill):
    ks = [K // 2, K]
    kw = dict(KW, pipeline_depth=depth, devices=devices, **({} if spill is None else dict(spill=spill)))
    clean = [int(v) for v in kt.kselect_streaming_many(CHUNKS, ks, device="cpu", spill_dir=str(tmp_path), **kw)]
    want = [int(np.sort(X, kind="stable")[k - 1]) for k in ks]
    assert clean == want
    staged = _booked()
    got = _run_both(tmp_path, lambda f: f.FaultPlan.seeded(seed, n_chunks=len(CHUNKS), faults=3),
                    lambda p, arm, root, o: [int(v) for v in p[2](arm(CHUNKS), ks, spill_dir=root, retry=_policy(p[0]),
                                                                  obs=o, **kw)])
    assert got[0][0] == ("ok", want), got
    assert got[0] == got[1]  # the answers, injector.fired and the FaultEvent streams
    assert got[0][1], "the plan fired nothing"
    _assert_clean(tmp_path, staged)


def test_chaos_float32_leg(tmp_path):
    fchunks = _chunks(dtype=np.float32, seed=3)
    fk = np.concatenate(fchunks).size // 3
    want = np.sort(np.concatenate(fchunks), kind="stable")[fk - 1]
    got = _run_both(tmp_path, lambda f: f.FaultPlan.seeded(5, n_chunks=len(fchunks), faults=3),
                    lambda p, arm, root, o: np.asarray(p[3](arm(fchunks), fk, spill="force", spill_dir=root,
                                                            retry=_policy(p[0]), obs=o, **KW)).tobytes())
    assert got[0][0] == ("ok", np.asarray(want).tobytes()) and got[0] == got[1]


def test_transient_connection_error_is_absorbed_by_default(tmp_path):
    """A replayable source that raises ConnectionError once, on the first
    pull of chunk 3, answers the oracle's value in both packages under the
    default ``retry`` (the port raised before its retry rung existed)."""
    rng = np.random.default_rng(0)
    chunks = [rng.integers(-(2**31), 2**31 - 1, size=4096, dtype=np.int64).astype(np.int32) for _ in range(6)]
    want = int(np.sort(np.concatenate(chunks))[9000 - 1])
    got = []
    for name in ("torch", "jax"):
        state = {"raised": False}

        def src():
            for i, c in enumerate(chunks):
                if i == 3 and not state["raised"]:
                    state["raised"] = True
                    raise ConnectionError("upstream hiccup")
                yield c

        got.append(int(_pkg(name)[3](src, 9000)))
        assert state["raised"]
    assert got == [want, want]


# ---------------------------------------------------------------------------
# the recovery ladder


def test_recover_pass_retries_retryable_oserror_subclasses():
    calls = []

    def run(src, tee):
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("transient network failure")
        return "ok"

    def wrong_rung(e):
        raise AssertionError("wrong rung")

    got = chunked._recover_pass(run, policy=_policy(faults), reading_spill=False, fallback=None,
                                on_enospc=wrong_rung, obs=None, site="t")
    assert got == "ok" and len(calls) == 3
    with pytest.raises(ConnectionError):
        chunked._recover_pass(lambda s, t: (_ for _ in ()).throw(ConnectionError("x")), policy=None,
                              reading_spill=False, fallback=None, on_enospc=None, obs=None, site="t")


def _spec(f, site, index, kind, attempts=(0,)):
    return f.FaultPlan((f.FaultSpec(site, index, kind, attempts=attempts),))


LADDER = {
    # name: (plan specs, call kwargs, one-shot source, expected: actions present / absent, or the error type)
    "reread once": ((("spill.read", 1, "corrupt", (0,)),), dict(spill="force"), False,
                    ({"reread"}, {"rebuild"})),
    "rebuild after corruption": ((("spill.read", 0, "corrupt_disk", (0,)),), dict(spill="force"), False,
                                 ({"reread", "rebuild"}, set())),
    "rebuild after truncation": ((("spill.read", 2, "truncate", (0,)),), dict(spill="force"), False,
                                 ({"reread", "rebuild"}, set())),
    "one-shot gen-0 anchor": ((("spill.read", 0, "corrupt_disk", (1,)),), dict(), True, ({"rebuild"}, set())),
    "one-shot gen-0 damage": ((("spill.read", 1, "corrupt_disk", (0,)),), dict(), True, "SpillRecordError"),
    "ladder with retry off": ((("spill.read", 0, "corrupt_disk", (0,)),), dict(spill="force", retry="off"), False,
                              ({"rebuild"}, set())),
    "enospc auto degrades": ((("spill.write", 0, "enospc", (1,)),), dict(), True, ({"degrade"}, set())),
    "enospc force raises": ((("spill.write", 0, "enospc", (1,)),), dict(spill="force"), False,
                            "SpillCapacityError"),
    "enospc teeing gen 0": ((("spill.write", 0, "enospc", (0,)),), dict(spill="force"), False,
                            "SpillCapacityError"),
    "hard write exhaustion": ((("spill.write", 0, "raise", tuple(range(1, 99))),),
                              dict(spill="force", retry="max2"), False, "RetryExhaustedError"),
    "stage retried in place": ((("stage", 1, "raise", (0,)),), dict(), False, ({"retry"}, set())),
    "stage exhausts": ((("stage", 1, "raise", tuple(range(99))),), dict(retry="max2"), False,
                       "RetryExhaustedError"),
    "source with retry off": ((("source", 1, "raise", (0,)),), dict(retry="off"), False, "TransientError"),
    "spill.write transient": ((("spill.write", 2, "raise", (0,)),), dict(spill="force"), False,
                              ({"retry"}, set())),
}


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("case", sorted(LADDER))
def test_recovery_ladder_matches_jax(tmp_path, case, depth):
    specs, kw, one_shot, expect = LADDER[case]
    staged = _booked()

    def call(p, arm, root, o):
        f = p[0]
        call_kw = dict(KW, pipeline_depth=depth, spill_dir=root, obs=o, **kw)
        if call_kw.get("retry") == "max2":
            call_kw["retry"] = f.RetryPolicy(max_attempts=2, sleeper=f.VirtualSleeper())
        elif "retry" not in call_kw:
            call_kw["retry"] = _policy(f)
        src = iter(list(CHUNKS)) if one_shot else arm(CHUNKS)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            v = int(p[3](src, K, **call_kw))
        return v, any("ENOSPC" in str(x.message) for x in w)

    got = _run_both(tmp_path, lambda f: f.FaultPlan(tuple(f.FaultSpec(s, i, k, attempts=a) for s, i, k, a in specs)),
                    call)
    assert got[0] == got[1], got
    (status, value), fired, events = got[0]
    if depth == 0 and all(site == "stage" for site, *_ in specs):
        expect = (set(), {"retry"})  # no staging at depth 0 (the JAX package's rule): nothing fires
    else:
        assert fired, "the plan fired nothing"
    if isinstance(expect, str):
        assert status == expect, got[0]
    else:
        assert status == "ok" and value[0] == WANT, got[0]
        actions = {e["action"] for e in events}
        assert expect[0] <= actions and not expect[1] & actions, actions
        assert value[1] == ("degrade" in actions)  # the downgrade's RuntimeWarning
    _assert_clean(tmp_path, staged)


def test_enospc_degrade_keeps_one_log_entry_a_pass(tmp_path):
    o = obs_lib.Observability.collecting()
    plan = _spec(faults, "spill.write", 0, "enospc", attempts=(1,))
    with faults.inject(plan, obs=o), warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        got = int(kt.kselect_streaming(iter(list(CHUNKS)), K, retry=_policy(faults), obs=o, spill_dir=str(tmp_path),
                                       device="cpu", **KW))
    assert got == WANT
    assert o.metrics.counter("spill.passes").value == len(o.events.of_kind("stream.pass"))
    assert o.metrics.counter("faults.recovered", labels={"site": "spill.write", "action": "degrade"}).value == 1
    assert _spill_dirs(tmp_path) == []


def test_stage_site_follows_the_jax_staging_rule(tmp_path):
    """The ``stage`` site fires where the JAX package stages: a histogram
    pass at depth >= 1 (keyed by the pass's staged-chunk count), the
    collect and the certificate only with ``devices``; never at depth 0."""
    specs = tuple(("stage", i, "stall", (0, 1, 2, 3, 4, 5, 6, 7)) for i in range(len(CHUNKS)))
    for depth, devices in ((0, None), (0, 2), (2, None), (2, 2)):
        got = _run_both(tmp_path, lambda f: f.FaultPlan(tuple(f.FaultSpec(s, i, k, attempts=a, arg=0.001)
                                                              for s, i, k, a in specs)),
                        lambda p, arm, root, o: int(p[3](CHUNKS, K, pipeline_depth=depth, devices=devices, obs=o,
                                                         **KW)))
        assert got[0] == got[1] and got[0][0] == ("ok", WANT)
        assert bool(got[0][1]) == (depth > 0)


def test_consumer_raise_with_stalled_producer_leaks_nothing():
    plan = faults.FaultPlan((faults.FaultSpec("source", 2, "stall", arg=0.05),))
    staged = _booked()
    with faults.inject(plan) as inj:  # the real sleeper: the stall blocks
        src = inj.wrap_chunk_source(lambda: iter(CHUNKS))
        with pytest.raises(KeyError):
            with chunked._key_chunk_stream(src, None, pipeline_depth=2, device=torch.device("cpu")) as kc:
                keys = None
                try:
                    keys, _ = next(iter(kc))
                    raise KeyError("consumer bug mid-stream")
                finally:
                    ex.release_staged(keys)
    assert _pipeline_threads() == [] and _booked() == staged


def test_certificate_recovers_a_transient_source_fault(tmp_path):
    got = _run_both(tmp_path, lambda f: _spec(f, "source", 2, "raise"),
                    lambda p, arm, root, o: tuple(int(c) for c in p[4](arm(CHUNKS), WANT, retry=_policy(p[0]),
                                                                       obs=o)))
    assert got[0] == got[1]
    less, leq = got[0][0][1]
    assert (less, leq) == kt.streaming_rank_certificate(CHUNKS, WANT, device="cpu") and less < K <= leq


def test_stream_invariants_hold_through_recovery(tmp_path):
    o = obs_lib.Observability.collecting()
    plan = faults.FaultPlan((faults.FaultSpec("source", 1, "raise"), faults.FaultSpec("spill.read", 0, "corrupt_disk")))
    with kt.SpillStore(str(tmp_path)) as store:
        with faults.inject(plan, obs=o) as inj:
            got = int(kt.kselect_streaming(inj.wrap_chunk_source(lambda: iter(CHUNKS)), K, spill=store,
                                           retry=_policy(faults), obs=o, device="cpu", **KW))
        log = list(store.pass_log)
    assert got == WANT
    obs_lib.check_stream_invariants(o.events.events, spill_pass_log=log)
    assert any(e["pass"] == "collect" for e in log)
    assert o.metrics.counter("faults.injected", labels={"site": "source"}).value >= 1
    assert o.metrics.counter("faults.retries", labels={"site": "source"}).value == 1
    assert _spill_dirs(tmp_path) == []


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("nvcc failed for sweep_ingest.cu"),
    TimeoutError("a kernel that does not return"),
])
def test_device_and_build_errors_are_never_retried(monkeypatch, tmp_path, error, depth):
    """A launch failure, a kernel that fails to build and running out of
    device memory propagate untouched under the default policy: no retry,
    no fallback, the same exception object. (A TimeoutError is retryable:
    the whole pass runs again, three times, then RetryExhaustedError.)"""
    calls = []

    def launch(*args, **kwargs):
        calls.append(1)
        raise error

    monkeypatch.setattr(ex, "sweep_ingest", launch)
    o = obs_lib.Observability.collecting()
    staged = _booked()
    with pytest.raises((type(error), RetryExhaustedError)) as ei:
        kt.kselect_streaming(CHUNKS, K, pipeline_depth=depth, spill="force", spill_dir=str(tmp_path), obs=o,
                             device="cpu", **KW)
    if isinstance(error, TimeoutError):
        assert isinstance(ei.value, RetryExhaustedError) and ei.value.__cause__ is error and len(calls) == 3
        assert [e.action for e in o.events.of_kind("fault")] == ["retry", "retry"]
    else:
        assert ei.value is error and len(calls) == 1 and not o.events.of_kind("fault")
    _assert_clean(tmp_path, staged)


def test_flight_recorder_dumps_once_on_exhaustion(tmp_path):
    """The hard form: a stage fault on every attempt exhausts the policy;
    the recorder writes exactly one bundle (in its ``dump_dir``) with the
    five sections, and nothing else is left behind."""
    import json

    rec = obs_lib.FlightRecorder(dump_dir=tmp_path)
    o = obs_lib.Observability(metrics=obs_lib.MetricsRegistry(), flight=rec)
    plan = faults.FaultPlan.seeded(3, sites=("stage",), recoverable=False, n_chunks=len(CHUNKS))
    staged = _booked()
    with faults.inject(plan, sleeper=faults.VirtualSleeper(), obs=o):
        with pytest.raises(RetryExhaustedError) as ei:
            kt.kselect_streaming(CHUNKS, K, retry=_policy(faults), obs=o, device="cpu", spill="force",
                                 spill_dir=str(tmp_path), **KW)
    assert (ei.value.site, ei.value.attempts) == ("stage", 3)
    # the frames the exception keeps alive hold no staged chunk's memory
    # (on the card: its allocated bytes back to their level before the call)
    held, tb = [], ei.value.__traceback__
    while tb is not None:
        held += [v for v in tb.tb_frame.f_locals.values() if isinstance(v, pl.StagedKeys)]
        tb = tb.tb_next
    assert held and all(k.data.untyped_storage().nbytes() == 0 for k in held)
    (path,) = rec.auto_dumps
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path)]
    assert os.path.basename(path).startswith(obs_lib.flight.FLIGHT_FILE_PREFIX)
    bundle = json.load(open(path))
    assert set(obs_lib.flight.BUNDLE_SECTIONS) <= set(bundle)
    assert bundle["reason"] == "retry-exhausted" and bundle["error"].startswith("RetryExhaustedError: stage:")
    assert bundle["faults"]["plan"].startswith("FaultPlan(") and bundle["lock_order"] is None
    actions = [e["action"] for e in bundle["faults"]["events"]]
    assert actions.count("inject") >= 3 and "retry" in actions
    assert bundle["metrics"]['faults.retries{site="stage"}']["value"] >= 2
    os.unlink(path)
    _assert_clean(tmp_path, staged)


@pytest.mark.gpu
def test_chaos_median_on_card(cuda_device, tmp_path):
    """The seeded chaos median on the card: the same bits as the fault-free
    call and NumPy's, the sweep kernel launched, the plan fired."""
    from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S

    clean = kt.kselect_streaming(CHUNKS, K, spill="force", spill_dir=str(tmp_path), **KW)
    plan = faults.FaultPlan((faults.FaultSpec("source", 1, "raise"), faults.FaultSpec("stage", 2, "raise"),
                             faults.FaultSpec("spill.write", 3, "raise", attempts=(1,)),
                             faults.FaultSpec("spill.read", 2, "corrupt_disk")))
    S.reset_counts()
    with faults.inject(plan, sleeper=faults.VirtualSleeper()) as inj:
        got = kt.kselect_streaming(inj.wrap_chunk_source(lambda: iter(CHUNKS)), K, spill="force",
                                   spill_dir=str(tmp_path), retry=_policy(faults), **KW)
    assert int(got) == int(clean) == WANT and len(inj.fired) == 4
    assert S.LAUNCHES["sweep_ingest32"] > 0 and not S.PLAIN_CALLS["sweep_ingest"]
    assert _spill_dirs(tmp_path) == []


# ---------------------------------------------------------------------------
# the CLI's --chaos / --retry / --debug-bundle against the JAX CLI


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_cli_chaos_matches_the_jax_cli(tmp_path, capsys, seed):
    """``--chaos SEED`` runs the solve under the same seeded plan as the JAX
    CLI: the same answer, plan and firings, and ``--check`` certifies the
    recovered answer against the clean stream."""
    import json

    from mpi_k_selection_tpu.cli import main as jax_main

    from mpi_k_selection_tpu_torch import cli

    argv = ["--streaming", "--n", "40000", "--chunk-elems", "8192", "--pipeline-depth", "2", "--spill", "force",
            "--chaos", str(seed), "--check", "--json"]
    recs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_main, [])):
        root = tmp_path / ("torch" if main is cli.main else "jax")
        root.mkdir()
        assert main(argv + extra + ["--spill-dir", str(root)]) == 0
        recs.append(json.loads([ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")][-1]))
        assert _spill_dirs(root) == []
    mine, theirs = recs
    assert mine["answer"] == theirs["answer"] and mine["extra"]["certificate_ok"] and theirs["extra"]["certificate_ok"]
    assert mine["extra"]["chaos"] == theirs["extra"]["chaos"] and mine["extra"]["chaos"]["fired"]
    assert mine["extra"]["rank_certificate"] == theirs["extra"]["rank_certificate"]
    assert mine["extra"]["retry"] == "default"


def test_cli_retry_off_fails_on_the_first_fault_like_the_jax_cli(tmp_path):
    """``--retry off``: the first injected transient ends the run with the
    JAX CLI's error (seed 0's plan raises on the first pull of chunk 0)."""
    from mpi_k_selection_tpu.cli import main as jax_main

    from mpi_k_selection_tpu_torch import cli

    said = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_main, [])):
        with pytest.raises(SystemExit) as ei:
            main(["--streaming", "--n", "40000", "--chunk-elems", "8192", "--pipeline-depth", "2", "--chaos", "0",
                  "--retry", "off", "--spill-dir", str(tmp_path), *extra])
        said.append(str(ei.value))
    assert said[0] == said[1] == "error: injected transient fault at source[0]"
    assert _spill_dirs(tmp_path) == []
