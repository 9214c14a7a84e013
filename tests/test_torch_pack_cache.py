"""The port's packed-weight cache (``packing/cache.py``) on the CPU.

* Keys: the reference's ``make_weight_key`` (same name, weight and layout:
  the same tag, dims, source dtype and content digest, a bf16 weight hashed
  as ``'bfloat16'`` over its raw 2-byte values), then the port's own field,
  for packed and tile-sparse layouts.
* Memory and disk round trips of every payload dtype (bf16, int8, int4,
  fp8, sparse bf16 and int8): payload bytes, scales and layout as they
  were; a disk hit comes off disk in a new instance.
* A corrupt, truncated or missing entry, or another schema version, is a
  miss; two writers on one directory merge their entries.
* ``REPRO_TORCH_PACK_CACHE``: unset or ``off`` is no cache, a directory a
  persistent one; the reference's ``REPRO_PACK_CACHE`` is never read.
* A second ``pack_params`` / ``sparsify_params`` / ``LM.init(pack=True)``
  through a disk cache is all hits and packs nothing.

Every test restores the process-global cache.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.packing import pack_operand as jpack  # noqa: E402
from repro.packing.cache import make_weight_key as jkey  # noqa: E402
from repro.sparse import sparsify_magnitude as jsparsify  # noqa: E402
from repro_torch.configs import base as tcb  # noqa: E402
from repro_torch.models.transformer import build_model  # noqa: E402
from repro_torch.packing import cache as C  # noqa: E402
from repro_torch.packing import pack as P  # noqa: E402
from repro_torch.packing.layout import PackedOperand  # noqa: E402
from repro_torch.packing.params import pack_params  # noqa: E402
from repro_torch.sparse import params as SP  # noqa: E402
from repro_torch.sparse import sparsify_magnitude  # noqa: E402
from repro_torch.sparse.params import sparsify_params  # noqa: E402

SMOKE = tcb.get("phi3-mini-3.8b", smoke=True)


@pytest.fixture(autouse=True)
def _global_cache():
    """The process-global cache and the lookup counts as they were."""
    saved = (C._global_cache, C._global_configured)
    C.reset_lookup_counts()
    yield
    C._global_cache, C._global_configured = saved


def _weight(shape, dtype, seed=0):
    """(numpy array for the reference, the same bits as a torch tensor)."""
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        w = w.astype(ml_dtypes.bfloat16)
        return w, torch.from_numpy(w.view(np.uint16)).view(torch.bfloat16)
    return w, torch.from_numpy(w)


@pytest.mark.parametrize("kind", ["packed-int8", "packed-int4-grouped",
                                  "packed-bfloat16", "sparse-magnitude"])
@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_key_is_the_reference_key_and_the_port_field(kind, src):
    shape = (3, 48, 40) if kind.endswith("grouped") else (48, 40)
    w, t = _weight(shape, src)
    blocks = (16, 8)
    if kind.startswith("packed"):
        fmt = kind.split("-")[1]
        lj = jpack(jnp.asarray(w), blocks, dtype=fmt).layout
        lt = P.pack_operand(t, blocks, dtype=fmt).layout
    else:
        lj = jsparsify(jnp.asarray(w), blocks, density=0.5).layout
        lt = sparsify_magnitude(t, blocks, density=0.5).layout
    assert lt.tag == lj.tag
    want = jkey("layers/3/attn/wq", jnp.asarray(w), lj)
    got = C.make_weight_key("layers/3/attn/wq", t, lt)
    assert got == want + "|" + C.PORT_FIELD
    assert C.weight_digest(t) == C.weight_digest(t.clone())
    assert C.weight_digest(t) != C.weight_digest(t + 1)


def _operands():
    w, t = _weight((40, 72), "float32", seed=1)
    ops = {fmt: P.pack_operand(t, (16, 32), dtype=fmt)
           for fmt in ("bfloat16", "int8", "int4", "fp8e4m3")}
    ops["grouped-int4"] = P.pack_operand(
        _weight((2, 40, 72), "float32", seed=2)[1], (16, 32), dtype="int4")
    ops["sparse-bfloat16"] = sparsify_magnitude(t.bfloat16(), (8, 16),
                                                density=0.5)
    ops["sparse-int8"] = sparsify_magnitude(t, (8, 16), density=0.5,
                                            dtype="int8")
    return t, ops


def _same(a, b):
    assert type(a) is type(b) and a.layout == b.layout
    assert a.payload.dtype == b.payload.dtype
    assert torch.equal(a.payload.view(torch.uint8),
                       b.payload.view(torch.uint8))
    assert (a.scales is None) == (b.scales is None)
    if a.scales is not None:
        assert torch.equal(a.scales, b.scales)


@pytest.mark.parametrize("where", ["memory", "disk"])
def test_round_trips_keep_every_payload_byte(where, tmp_path):
    t, ops = _operands()
    path = tmp_path / "c" if where == "disk" else None
    cache = C.PackedWeightCache(path)
    for name, op in ops.items():
        cache.put(name, op)
    reader = C.PackedWeightCache(path) if path else cache
    assert reader.keys() == sorted(ops) and len(reader) == len(ops)
    for name, op in ops.items():
        assert name in reader
        _same(reader.get(name), op)
    assert reader.get("absent") is None
    if path:
        index = json.loads((path / "index.json").read_text())
        assert index["version"] == 1 and len(index["entries"]) == len(ops)
        cache.clear()
        assert C.PackedWeightCache(path).keys() == []
        assert not list(path.glob("*.npz"))


def test_corrupt_entries_are_misses(tmp_path):
    t, ops = _operands()
    cache = C.PackedWeightCache(tmp_path)
    for name in ("int8", "int4", "bfloat16"):
        cache.put(name, ops[name])
    entries = json.loads((tmp_path / "index.json").read_text())["entries"]
    (tmp_path / entries["int8"]["file"]).write_bytes(b"not a zip")
    np.savez(tmp_path / entries["int4"]["file"],
             payload=np.zeros(7, np.uint8), scales=np.zeros(3, np.float32))
    (tmp_path / entries["bfloat16"]["file"]).unlink()
    fresh = C.PackedWeightCache(tmp_path)
    assert [fresh.get(n) for n in ("int8", "int4", "bfloat16")] == [None] * 3
    # A miss rebuilds and replaces the entry.
    built = fresh.get_or_pack("w", t, (16, 32), dtype="int8")
    assert (fresh.hits, fresh.misses) == (0, 1)
    _same(C.PackedWeightCache(tmp_path).get_or_pack("w", t, (16, 32),
                                                    dtype="int8"), built)
    for text in ("{", json.dumps({"version": 2, "entries": entries}),
                 json.dumps([1, 2])):
        (tmp_path / "index.json").write_text(text)
        assert C.PackedWeightCache(tmp_path).keys() == []


def test_two_writers_merge(tmp_path):
    _, ops = _operands()
    a, b = C.PackedWeightCache(tmp_path), C.PackedWeightCache(tmp_path)
    a.put("int8", ops["int8"])
    b.put("int4", ops["int4"])
    a.put("fp8e4m3", ops["fp8e4m3"])
    assert C.PackedWeightCache(tmp_path).keys() == ["fp8e4m3", "int4",
                                                    "int8"]


@pytest.mark.parametrize("value", [None, "", "off", "0", "none",
                                   "disabled", "dir"])
def test_environment_variable(value, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PACK_CACHE", str(tmp_path / "reference"))
    if value is None:
        monkeypatch.delenv(C.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(C.ENV_VAR, str(tmp_path / "port")
                           if value == "dir" else value)
    C._global_cache, C._global_configured = None, False
    got = C.get_pack_cache()
    if value == "dir":
        assert got.path == tmp_path / "port"
    else:
        assert got is None
    mem = C.PackedWeightCache(None)
    assert C.set_pack_cache(mem) is got and C.get_pack_cache() is mem


def _no_packer(*a, **k):
    raise AssertionError("a cache hit must not pack")


def test_second_pack_params_is_all_hits(tmp_path, monkeypatch):
    tm = build_model(SMOKE, policy="bf16", device="cpu")
    params = tm.init_train(torch.Generator().manual_seed(0))
    first = pack_params(params, pack_format="int4",
                        cache=C.PackedWeightCache(tmp_path))
    n = 7 * SMOKE.n_layers + 1
    assert C.lookup_counts() == {"packed_miss": n}
    monkeypatch.setattr(P, "pack_operand", _no_packer)
    cache = C.PackedWeightCache(tmp_path)
    again = pack_params(params, pack_format="int4", cache=cache)
    assert (cache.hits, cache.misses) == (n, 0)
    assert any(k.startswith("layers/1/mlp/w_down|") for k in cache.keys())
    _same(first["layers"][1]["mlp"]["w_down"],
          again["layers"][1]["mlp"]["w_down"])
    _same(first["head"], again["head"])


def test_second_sparsify_params_is_all_hits(tmp_path, monkeypatch):
    cfg = tcb.get("granite-moe-1b-a400m", smoke=True)
    tm = build_model(cfg, policy="int8", device="cpu")
    params = tm.init_train(torch.Generator().manual_seed(0))
    kw = dict(cfg=cfg, method="nm", policy="int8", blocks=(32, 32))
    first = sparsify_params(params, cache=C.PackedWeightCache(tmp_path), **kw)
    monkeypatch.setattr(SP, "build_payload", _no_packer)
    cache = C.PackedWeightCache(tmp_path)
    again = sparsify_params(params, cache=cache, **kw)
    n = 7 * cfg.n_layers
    assert (cache.hits, cache.misses) == (n, 0)
    assert C.lookup_counts() == {"tile_sparse_miss": n, "tile_sparse_hit": n}
    _same(first["layers"][0]["w_up"], again["layers"][0]["w_up"])
    # The layers of a stack still share one layout and index tensors.
    assert (again["layers"][0]["w_up"].indptr
            is again["layers"][1]["w_up"].indptr)


def test_init_through_the_global_cache_names_each_layer(tmp_path,
                                                        monkeypatch):
    tm = build_model(SMOKE, policy="bf16", device="cpu")
    C.set_pack_cache(C.PackedWeightCache(tmp_path))
    first = tm.init(torch.Generator().manual_seed(0), pack=True,
                    pack_format="int4")
    keys = C.get_pack_cache().keys()
    assert {k.split("|")[0] for k in keys} >= {
        "layers/0/attn/wq", "layers/1/attn/wq", "layers/1/mlp/w_gate"}
    C.set_pack_cache(C.PackedWeightCache(tmp_path))
    monkeypatch.setattr(P, "pack_operand", _no_packer)
    again = tm.init(torch.Generator().manual_seed(0), pack=True,
                    pack_format="int4")
    assert C.get_pack_cache().hits == len(keys)
    for a, b in zip(first["layers"], again["layers"]):
        _same(a["attn"]["wo"], b["attn"]["wo"])
    assert isinstance(again["layers"][0]["mlp"]["w_up"], PackedOperand)
