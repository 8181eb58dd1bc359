"""The port's width schedule (``width_schedule``) and its use with packed
spill records (``pack_spill``) in the streamed descent, against the JAX
package, bit for bit.

The knob checks and the schedule's resolution raise the JAX package's
errors with its messages; on the same seeded chunks every schedule and
record format gives the same answers as NumPy's key order, and a spilled
descent's ``pass_log`` (pass labels, keys, logical and physical bytes)
equals the JAX package's entry for entry. Stores root in each test's
``tmp_path``, which holds no ``ksel-spill-*`` afterwards. The JAX package
is imported inside the tests, so the ``gpu`` tests also collect where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_*.py -m gpu
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import mpi_k_selection_tpu_torch as kt
from mpi_k_selection_tpu_torch.ops.cuda import sweep_ingest as S
from mpi_k_selection_tpu_torch.streaming import chunked
from mpi_k_selection_tpu_torch.streaming.sketch import RadixSketch
from mpi_k_selection_tpu_torch.streaming.spill import SpillStore
from mpi_k_selection_tpu_torch.utils import dtypes as dt
from test_torch_spill import NARROW, _spilled, jax_store, spill_dirs
from test_torch_streaming import DTYPES, bits, cuda_device, key_oracle, stream  # noqa: F401 (a fixture)

# a tuple schedule a dtype's key bits resolve (widths up to the 20-bit cap)
TUPLES = {8: (3, 5), 16: (12, 4), 32: (20, 4, 8), 64: (20, 20, 16, 8)}


def outcome(fn, *args, **kw):
    """``("ok", value)`` or ``(exception class name, message)``."""
    try:
        return "ok", fn(*args, **kw)
    except (ValueError, TypeError) as e:
        return type(e).__name__, str(e)


KNOB_VALUES = [None, "auto", "off", (16, 8, 8), [4] * 8, (20,), (1, 20), (), "on", "Auto", 5, (0,), (21,), (16, -1),
               (16, "x"), range(1, 3)]


@pytest.mark.parametrize("value", KNOB_VALUES, ids=repr)
def test_validate_width_schedule_matches_jax(value):
    """Every mode, tuples, lists and ranges, and each refusal, with the JAX
    package's result or exception and message."""
    from mpi_k_selection_tpu.streaming.chunked import validate_width_schedule as ref

    assert outcome(chunked.validate_width_schedule, value) == outcome(ref, value)


@pytest.mark.parametrize("total_bits", [8, 16, 32, 64])
def test_resolve_width_schedule_matches_jax(total_bits):
    """``"auto"``, ``"off"`` and tuples at every radix width and sketch
    start depth: the same widths, or the same error text (the
    divisibility refusal of ``"off"``, with and without a sketch, and a
    tuple that misses the bits to resolve). One case differs on purpose:
    ``"auto"`` with a radix width above 16 that does not divide the bits
    left, where the JAX package returns widths short of them (and its
    descent would fail a pass later); the port raises ``"off"``'s
    divisibility error."""
    from mpi_k_selection_tpu.streaming.chunked import resolve_width_schedule as ref

    seen = set()
    short = 0
    for radix_bits in range(1, 21):
        for start in (0, 4, 6, 8, 12, 16, 20):
            if start >= total_bits:
                continue
            left = total_bits - start
            for mode in ("auto", "off", TUPLES[total_bits], split20(left), (7,)):
                got = outcome(chunked.resolve_width_schedule, mode, total_bits, radix_bits, start_bits=start)
                want = outcome(ref, mode, total_bits, radix_bits, start_bits=start)
                if mode == "auto" and want[0] == "ok" and sum(want[1]) != left:
                    assert radix_bits > 16 and left % radix_bits
                    assert got == outcome(ref, "off", total_bits, radix_bits, start_bits=start)
                    short += 1
                    continue
                assert got == want, (mode, radix_bits, start)
                seen.add(got[0])
                if got[0] == "ok":
                    assert sum(got[1]) == left and all(1 <= w <= 20 for w in got[1])
    assert seen == {"ok", "ValueError"} and short == {8: 0, 16: 0, 32: 0, 64: 2}[total_bits]
    assert chunked.MAX_PASS_BITS == 20 and chunked.WIDTH_SCHEDULE_MODES == ("auto", "off")
    assert chunked.DEFAULT_WIDTH_SCHEDULE == chunked.DEFAULT_PACK_SPILL == "off"


def test_auto_schedules_are_the_jax_packages():
    """The schedules the slice's measurements rest on."""
    r = chunked.resolve_width_schedule
    assert r("auto", 32, 8) == (16, 8, 8) and r("auto", 64, 8) == (16, 16, 8, 8, 8, 8)
    assert r("auto", 64, 4) == (16, 16) + (4,) * 8 and r("auto", 64, 8, start_bits=32) == (16, 8, 8)
    assert r("auto", 16, 8) == (16,) and r("auto", 8, 8) == (8,) and r("auto", 32, 4, start_bits=16) == (16,)


@pytest.mark.parametrize("name", DTYPES)
def test_knob_grid_matches_jax(name, tmp_path):
    """``width_schedule`` in {off, auto, a tuple} x ``pack_spill`` in {off,
    auto} x spill in {off, force, a one-shot source}, four ranks at once,
    at depth 2 and 0: the answers are NumPy's key order; the spill-forced
    pass logs equal the JAX package's entry for entry (bfloat16 answers
    only: the JAX package cannot read its own bfloat16 records back and
    rebuilds from the source); each certificate brackets its rank."""
    from mpi_k_selection_tpu.streaming import streaming_kselect_many as ref_many
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=31)
    x = np.concatenate(chunks)
    n = x.size
    ks = [1, n // 3, n // 2, n]
    want = key_oracle(x, ks)
    keys = dt.np_to_sortable_bits(x)
    for ws in ("off", "auto", TUPLES[dt.key_bits(x.dtype)]):
        for ps in ("off", "auto"):
            knobs = dict(width_schedule=ws, pack_spill=ps, **NARROW)
            for depth, spill in ((2, "off"), (0, "force"), (2, "one-shot")):
                src = (c for c in chunks) if spill == "one-shot" else chunks
                got = kt.kselect_streaming_many(src, ks, pipeline_depth=depth, spill="auto" if spill == "one-shot"
                                                else spill, spill_dir=str(tmp_path), device="cpu", **knobs)
                assert bits(got, x.dtype) == want, (ws, ps, spill)
            mine = SpillStore(str(tmp_path))
            kt.kselect_streaming_many(chunks, ks, spill=mine, device="cpu", **knobs)
            if name != "bfloat16":
                theirs = jax_store(tmp_path)
                with enable_x64():
                    ref_many(chunks, ks, spill=theirs, **knobs)
                assert mine.pass_log == theirs.pass_log, (ws, ps)
                theirs.close()
            labels = [e["pass"] for e in mine.pass_log[:-1]]
            assert labels == sorted(set(labels)) and len(mine.pass_host_ms) == len(mine.pass_log)
            assert all(e["disk_bytes_read"] <= e["bytes_read"] for e in mine.pass_log)
            mine.close()
    v = np.frombuffer(want, x.dtype)[2]
    vkey = dt.np_to_sortable_bits(np.asarray([v]))[0]
    assert kt.streaming_rank_certificate(chunks, v, width_schedule="auto", pack_spill="auto", device="cpu") == (
        int((keys < vkey).sum()), int((keys <= vkey).sum()))
    assert not spill_dirs(tmp_path)


@pytest.mark.parametrize("name", ["int8", "uint16", "int32", "float32", "uint64", "float64"])
def test_pass_labels_match_jax(name, tmp_path):
    """Under ``"auto"`` and a tuple, on the default 8-bit digits, the pass
    labels (``start // radix_bits + step``) and the byte columns equal the
    JAX package's, with and without packing; ``"off"`` and the defaults
    give one pass log."""
    chunks = stream(name, seed=33, sizes=(4000, 0, 1, 3000))
    x = np.concatenate(chunks)
    ks = [7, x.size // 2]
    logs = {}
    for ws in ("auto", TUPLES[dt.key_bits(x.dtype)], "off", None):
        for ps in ("auto", "off"):
            kw = dict(collect_budget=16, pack_spill=ps) | ({} if ws is None else {"width_schedule": ws})
            got, mine = _spilled("port", chunks, ks, tmp_path / "port", 2, **kw)
            want, theirs = _spilled("jax", chunks, ks, tmp_path / "jax", 2, **kw)
            assert bits(got, x.dtype) == bits(want, x.dtype) == key_oracle(x, ks)
            assert mine.pass_log == theirs.pass_log, (ws, ps)
            logs[(ws, ps)] = mine.pass_log
            mine.close()
            theirs.close()
    assert logs[("off", "off")] == logs[(None, "off")] and logs[("off", "auto")] == logs[(None, "auto")]
    assert [e["pass"] for e in logs[("auto", "off")]][0] == 0
    assert not spill_dirs(tmp_path / "port")


def split20(bits: int) -> tuple:
    """``bits`` as a tuple of widths of at most 20."""
    return (20,) * (bits // 20) + ((bits % 20,) if bits % 20 else ())


@pytest.mark.parametrize("name", ["uint32", "float32", "int64"])
def test_sketch_seeded_refine_with_knobs_matches_jax(name, tmp_path):
    """A sketch-seeded ``refine`` / ``refine_many`` under every schedule
    and both formats, from the stream and from a store teed by
    ``update_stream``: NumPy's answers; the schedule starts below the
    sketch's resolved bits, and a tuple that misses them raises the JAX
    package's error."""
    from mpi_k_selection_tpu.streaming.sketch import RadixSketch as JaxSketch
    from mpi_k_selection_tpu.utils.x64 import enable_x64

    chunks = stream(name, seed=35, sizes=(1500, 0, 1700, 900))
    x = np.concatenate(chunks)
    ks = [1, x.size // 4, x.size]
    want = key_oracle(x, ks)
    left = dt.key_bits(x.dtype) - 16
    sk = RadixSketch(x.dtype, device="cpu").update_stream(chunks)
    for ws in ("off", "auto", split20(left)):
        for ps in ("off", "auto"):
            kw = dict(collect_budget=16, width_schedule=ws, pack_spill=ps)
            assert bits([sk.refine(chunks, k, **kw) for k in ks], x.dtype) == want
            with SpillStore(str(tmp_path)) as store:
                RadixSketch(x.dtype, device="cpu").update_stream(iter(chunks), spill=store, pack_spill=ps)
                assert bits(sk.refine_many(store, ks, spill=store, **kw), x.dtype) == want
                log = list(store.pass_log)
            with jax_store(tmp_path) as theirs, enable_x64():
                jsk = JaxSketch(x.dtype).update_stream(iter(chunks), spill=theirs, pack_spill=ps)
                assert bits(jsk.refine_many(theirs, ks, spill=theirs, **kw), x.dtype) == want
                assert log == theirs.pass_log, (ws, ps)
    with pytest.raises(ValueError, match="minus the sketch's 16 resolved"):
        sk.refine(chunks, 1, width_schedule=(8,))
    assert not spill_dirs(tmp_path)


def test_streaming_quantiles_carries_the_knobs(tmp_path):
    """``StreamingQuantiles(width_schedule=, pack_spill=)``: its tee is the
    JAX tracker's generation byte for byte, its refinement's pass log the
    JAX tracker's, and ``merge`` keeps the knobs."""
    from mpi_k_selection_tpu.api import StreamingQuantiles as JaxTracker
    from mpi_k_selection_tpu.api import quantile_ranks
    from mpi_k_selection_tpu.utils.x64 import enable_x64
    from test_torch_spill import generation_files

    chunks = stream("float32", seed=37, sizes=(3000, 1, 2500))
    x = np.concatenate(chunks)
    qs = [0.1, 0.5, 0.999]
    want = key_oracle(x, quantile_ranks(qs, x.size))
    for ws, ps in (("auto", "auto"), ((12, 4), "off")):
        with SpillStore(str(tmp_path / "port")) as store, jax_store(tmp_path / "jax") as theirs:
            t = kt.StreamingQuantiles(x.dtype, width_schedule=ws, pack_spill=ps, device="cpu")
            t.update_stream(iter(chunks), spill=store)
            with enable_x64():
                jt = JaxTracker(x.dtype, width_schedule=ws, pack_spill=ps).update_stream(iter(chunks), spill=theirs)
                assert generation_files(store) == generation_files(theirs)
                assert bits(t.refine_quantiles(qs, store), x.dtype) == want
                assert bits(jt.refine_quantiles(qs, theirs), x.dtype) == want
            assert store.pass_log == theirs.pass_log
            m = t.merge(t)
            assert (m.width_schedule, m.pack_spill, m.n) == (ws, ps, 2 * x.size)
    assert not spill_dirs(tmp_path / "port")


def test_knobs_checked_before_the_stream(tmp_path):
    """Bad knob values raise the JAX package's errors before a chunk is
    read, on every entry point; a schedule that does not fit the stream's
    key bits raises at pass 0's dtype probe."""
    read = []

    def src():
        read.append(1)
        return iter([np.arange(10, dtype=np.int32)])

    for call in (lambda **kw: kt.kselect_streaming(src, 1, device="cpu", **kw),
                 lambda **kw: kt.kselect_streaming_many(src, [1, 2], device="cpu", **kw),
                 lambda **kw: kt.streaming_rank_certificate(src, 3, device="cpu", **kw)):
        with pytest.raises(ValueError, match="width_schedule must be one of"):
            call(width_schedule="wide")
        with pytest.raises(ValueError, match="outside \\[1, 20\\]"):
            call(width_schedule=(24, 8))
        with pytest.raises(ValueError, match="pack_spill must be one of"):
            call(pack_spill="always")
    assert not read
    with pytest.raises(ValueError, match="resolves 24 bits but the descent must resolve 32"):
        kt.kselect_streaming(src, 1, width_schedule=(16, 8), device="cpu")
    with pytest.raises(ValueError, match="must divide key bits 32"):
        kt.kselect_streaming(src, 1, radix_bits=5, device="cpu")
    assert kt.kselect_streaming(src, 4, radix_bits=5, width_schedule="auto", device="cpu") == 3


def test_cli_width_and_pack_flags(tmp_path, capsys):
    """``--width-schedule`` and ``--pack-spill`` on the streamed mode:
    exact, certified from the packed generation 0, recorded in ``extra``
    as the JAX CLI records them; bad values exit with its messages."""
    from mpi_k_selection_tpu_torch import cli

    for ws, rec_ws in (("auto", "auto"), ("16,8,8", [16, 8, 8])):
        rc = cli.main([
            "--streaming", "--n", "40000", "--chunk-elems", "8192", "--spill", "force", "--spill-dir",
            str(tmp_path), "--width-schedule", ws, "--pack-spill", "auto", "--check", "--verify", "--json",
            "--device", "cpu",
        ])
        rec = json.loads(capsys.readouterr().out)
        assert rc == 0 and rec["extra"]["width_schedule"] == rec_ws and rec["extra"]["pack_spill"] == "auto"
        assert rec["extra"]["exact_match"] is True and rec["extra"]["certificate_ok"] is True
    for bad, msg in (("16,x", "comma-separated ints"), ("40", "outside"), ("wide", "comma-separated ints")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(["--streaming", "--n", "1000", "--width-schedule", bad, "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["--streaming", "--n", "1000", "--pack-spill", "on", "--device", "cpu"])
    assert not spill_dirs(tmp_path)


# -- on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["int16", "uint32", "bfloat16", "float32", "int64", "float64"])
def test_knobs_on_card(cuda_device, name, tmp_path):
    """Both knobs with the sweep kernel on the card: NumPy's answers, the
    kernel launched and no plain call, and the generations (the pass-0
    records packed on the card) equal file for file to the CPU's."""
    from test_torch_spill import generation_files

    chunks = stream(name, seed=39, sizes=(70000, 1, 0, 33000))
    x = np.concatenate(chunks)
    ks = [1, x.size // 2, x.size]
    want = key_oracle(x, ks)
    kname = "sweep_ingest64" if dt.key_bits(x.dtype) == 64 else "sweep_ingest32"
    for ws in ("auto", TUPLES[dt.key_bits(x.dtype)]):
        S.reset_counts()
        got = kt.kselect_streaming_many(iter(chunks), ks, spill="auto", spill_dir=str(tmp_path), width_schedule=ws,
                                        pack_spill="auto", device=cuda_device, collect_budget=64)
        assert bits(got, x.dtype) == want
        assert S.LAUNCHES[kname] > 0 and S.PLAIN_CALLS["sweep_ingest"] == 0
        files = []
        for device in (cuda_device, "cpu"):
            store = SpillStore(str(tmp_path))
            store.drop_generation = lambda gen: None
            kt.kselect_streaming_many(chunks, ks, spill=store, width_schedule=ws, pack_spill="auto", device=device,
                                      collect_budget=64)
            files.append(generation_files(store))
            store.close()
        assert len(files[0]) >= 3 and files[0] == files[1]  # 16-bit keys: one "auto" pass, generation 0 alone
    assert not spill_dirs(tmp_path)


@pytest.mark.gpu
@pytest.mark.parametrize("bits_", [32, 64])
@pytest.mark.parametrize("width", [16, 17, 18, 19, 20])
def test_wide_histogram_launch_matches_plain_on_card(cuda_device, bits_, width):
    """Row 8's histogram part at the schedule's widths: no prefix (a first
    pass), one prefix and four, exactly the plain version's counts."""
    gen = torch.Generator(device="cuda").manual_seed(width)
    n = (1 << 20) + 77
    w = torch.randint(-(1 << 62), 1 << 62, (n,), dtype=torch.int64, device="cuda", generator=gen)
    w = w.to(torch.int32) if bits_ == 32 else w
    keys = dt.keys_from_raw(w, "xor", 1 << (bits_ - 1))
    tops = sorted({int(dt.shift_right_logical(keys[i:i + 1], bits_ - 4, bits_)) for i in range(0, 4000, 1000)})
    for shift, prefixes in ((bits_ - width, [0]), (bits_ - 4 - width, tops[:1]), (bits_ - 4 - width, tops)):
        kw = dict(key_op="xor", key_xor=1 << (bits_ - 1), hist_prefixes=prefixes, shift=shift, radix_bits=width)
        got = S.sweep_ingest(w, n - 5, **kw)[0]
        assert torch.equal(got.cpu(), S.sweep_ingest_plain(w.cpu(), n - 5, **kw)[0])
