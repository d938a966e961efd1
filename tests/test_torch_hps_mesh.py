"""The HPS L1 striped across devices: the mesh half of the reference's
``hps_gather.sharded_gather_rows`` / ``sharded_dequant_gather_rows``.

The reference runs as its own tests run it (``tests/test_hps_sharded.py``):
one subprocess with four forced host devices and ``make_cache_mesh(8)``.
The port's cache mesh is a list of devices, here four entries of ``cpu``
(a list may repeat a device, as one card does on the chip): each entry
holds its block of stripes and reads its own slots, the others' set to -1,
and the partial rows are summed once. Against the reference's values:

* ``sharded_cache_gather`` over the mesh: f32 bit-exact, int8 and f16
  (``q * scale`` per device) bit-exact; the pooled read (f32 against the
  reference's, every type against the one-device striped read);
* ``ShardedPayloadStore`` on the mesh: scatter then gather, f32 / f16 /
  int8 read back as the reference's store reads them;
* a sharded ``HPS`` (``cache_mesh``, ``cache_shards=4``) against the
  unsharded one on the same query stream, bit for bit, and against the
  reference's sharded HPS;
* the owner-mapped read (``hps_gather.owned_read``, one launch an entry
  for every table): each slot placed by its owner entry alone, the
  entries' rows meeting in the flat read bit for bit, on this device and
  through the other-device branch (``local``) of ``ops.mesh_pooled_read``;
* the served pooled read of several tables at once
  (``hps._pooled_stack`` over the mesh: H 1 and mixed H up to 3, ``sum``
  and ``mean``, f32 / f16 / int8) against the reference's stack of
  per-table ``sharded_pooled_lookup`` over its four devices and, bit for
  bit, the one-device read.
"""
import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys

import numpy as np

from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.core.hps.hps import HPS, _pooled_stack
from repro_torch.core.hps.payload_store import ShardedPayloadStore
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.kernels import hps_gather, ops
from repro_torch.launch.mesh import make_cache_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = make_cache_mesh(8, devices=["cpu"] * 4)
DTYPES = ("f32", "f16", "int8")
QUERIES = 4
#: the stacked tables' rows a stripe (8 stripes each, D 8), their H in the
#: mixed case, and their combiners
STACK_CL = (16, 8, 24, 16)
STACK_H3 = (3, 1, 3, 2)
STACK_COMBINERS = ("sum", "mean", "sum", "mean")

JAX_SCRIPT = r"""
import os, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.base import EmbeddingTableConfig
from repro.core.hps.hps import HPS
from repro.core.hps.payload_store import quantize_rows
from repro.core.hps.persistent_db import PersistentDB
from repro.kernels import ops
from repro.launch.mesh import make_cache_mesh
tmp = sys.argv[1]
inp = dict(np.load(os.path.join(tmp, "in.npz")))
mesh = make_cache_mesh(8)
assert mesh.shape["cache"] == 4
out = {}
stripes = jnp.asarray(inp["stripes"])
out["gather_f32"] = np.asarray(ops.sharded_cache_gather(
    stripes, inp["slots"], mesh=mesh))
for dt in ("f16", "int8"):
    q, sc = quantize_rows(inp["stripes"].reshape(-1, 8), dt)
    if sc is None:
        sc = np.ones(q.shape[0], np.float32)
    qs = jnp.asarray(q.reshape(8, 16, 8))
    scs = jnp.asarray(sc.reshape(8, 16))
    out[f"gather_{dt}"] = np.asarray(ops.sharded_cache_gather(
        qs, inp["slots"], scales=scs, mesh=mesh))
out["pooled_f32"] = np.asarray(ops.sharded_pooled_lookup(
    stripes, jnp.asarray(inp["pslots"]), mesh=mesh))
from repro.core.hps.hps import _pooled_stack
combs = ("sum", "mean", "sum", "mean")
for dt in ("f32", "f16", "int8"):
    pays = []
    for t in range(4):
        r = inp[f"stack_rows{t}"]
        cl = r.shape[0] // 8
        q, sc = (r, None) if dt == "f32" else quantize_rows(r, dt)
        pays.append((jnp.asarray(q.reshape(8, cl, 8)),
                     None if sc is None else jnp.asarray(sc.reshape(8, cl))))
    for hc in ("h1", "h3"):
        sl = tuple(jnp.asarray(inp[f"stack_{hc}_{t}"]) for t in range(4))
        out[f"stack_{dt}_{hc}"] = np.asarray(_pooled_stack(
            tuple(pays), sl, combs, shards=8, mesh=mesh))
pdb = PersistentDB(os.path.join(tmp, "pdb_jax"))
tabs = []
for i in range(3):
    pdb.create_table("m", f"t{i}", 120, 8, initial=inp[f"table{i}"])
    tabs.append(EmbeddingTableConfig(f"t{i}", 120, 8, hotness=4,
                                     combiner="mean" if i % 2 else "sum"))
h = HPS("m", tabs, pdb, cache_capacity=32, cache_shards=4,
        cache_mesh=make_cache_mesh(4))
for k in range(int(inp["queries"])):
    out[f"hps_{k}"] = np.asarray(h.lookup(inp[f"cat{k}"]))
np.savez(os.path.join(tmp, "jax.npz"), **out)
print("JAX_OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The inputs, and the reference's values over four forced devices."""
    tmp = str(tmp_path_factory.mktemp("hps_mesh"))
    rng = np.random.default_rng(1)
    inp = {"stripes": rng.normal(size=(8, 16, 8)).astype(np.float32),
           "slots": rng.integers(-1, 128, size=37).astype(np.int32),
           "pslots": rng.integers(-1, 128, size=(6, 5)).astype(np.int32),
           "sl": np.arange(0, 120, 3, dtype=np.int64),
           "queries": np.asarray(QUERIES)}
    inp["rows"] = rng.normal(size=(len(inp["sl"]), 8)).astype(np.float32)
    for i in range(3):
        inp[f"table{i}"] = np.random.default_rng(50 + i).normal(
            size=(120, 8)).astype(np.float32)
    for k in range(QUERIES):
        inp[f"cat{k}"] = rng.integers(-1, 120, size=(8, 3, 4)).astype(
            np.int32)
    for t, (cl, h) in enumerate(zip(STACK_CL, STACK_H3)):
        inp[f"stack_rows{t}"] = rng.normal(size=(8 * cl, 8)).astype(
            np.float32)
        for hc, hh in (("h1", 1), ("h3", h)):
            inp[f"stack_{hc}_{t}"] = rng.integers(
                -1, 8 * cl, size=(6, hh)).astype(np.int32)
    np.savez(os.path.join(tmp, "in.npz"), **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, tmp], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    return inp, dict(np.load(os.path.join(tmp, "jax.npz"))), tmp


def _quantized(stripes, dt):
    from repro_torch.core.hps.payload_store import quantize_rows
    q, sc = quantize_rows(stripes.reshape(-1, stripes.shape[-1]), dt)
    if sc is None:
        sc = np.ones(q.shape[0], np.float32)
    return (torch.from_numpy(q.reshape(stripes.shape)),
            torch.from_numpy(sc.reshape(stripes.shape[:2])))


def test_cache_mesh_keeps_the_reference_degrade_rule():
    assert len(MESH) == 4 and all(d.type == "cpu" for d in MESH)
    for stripes, n, want in ((8, 4, 4), (6, 4, 3), (7, 4, 1), (2, 4, 2),
                             (4, 1, 1)):
        assert len(make_cache_mesh(stripes, devices=["cpu"] * n)) == want


@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_gather_matches_jax(ref, dt):
    inp, want, _ = ref
    if dt == "f32":
        blocks, scales = ops.place_stripes(torch.from_numpy(inp["stripes"]),
                                           None, MESH)
        got = ops.sharded_cache_gather(blocks, inp["slots"], mesh=MESH)
        np.testing.assert_array_equal(got.numpy(), want["gather_f32"])
    else:
        blocks, scales = ops.place_stripes(*_quantized(inp["stripes"], dt),
                                           MESH)
        got = ops.sharded_cache_gather(blocks, inp["slots"], scales=scales,
                                       mesh=MESH)
        np.testing.assert_array_equal(got.numpy(), want[f"gather_{dt}"])
    # the mesh read is the one-device striped read, row for row
    flat_s, flat_sc = (torch.from_numpy(inp["stripes"]), None) \
        if dt == "f32" else _quantized(inp["stripes"], dt)
    one = ops.sharded_cache_gather(flat_s, inp["slots"], scales=flat_sc)
    np.testing.assert_array_equal(got.numpy(), one.numpy())


@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_pooled_lookup_matches_jax(ref, dt):
    """The pooled read over the mesh: the one-device striped read's, and
    (f32) the reference's over its four devices."""
    inp, want, _ = ref
    s, sc = (torch.from_numpy(inp["stripes"]), None) if dt == "f32" \
        else _quantized(inp["stripes"], dt)
    blocks, scales = ops.place_stripes(s, sc, MESH)
    pslots = torch.from_numpy(inp["pslots"])
    got = ops.sharded_pooled_lookup(blocks, pslots, scales=scales,
                                    mesh=MESH)
    one = ops.sharded_pooled_lookup(s, pslots, scales=sc)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-6,
                               atol=1e-6)
    if dt == "f32":
        np.testing.assert_allclose(got.numpy(), want["pooled_f32"],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dt", DTYPES)
def test_store_on_the_mesh_matches_jax(ref, dt):
    """Scatter then gather on the mesh reads the rows the reference's
    store reads (its mesh store reads what its one-device store does:
    ``tests/test_hps_sharded.py``)."""
    import jax.numpy as jnp
    from repro.core.hps.payload_store import ShardedPayloadStore as JStore
    inp, _, _ = ref
    st = ShardedPayloadStore(120, 8, shards=8, mesh=MESH, payload_dtype=dt,
                             device="cpu")
    payload, _ = st.snapshot()
    assert len(payload) == 4 and payload[0].shape[0] == 2
    st.scatter(inp["sl"], inp["rows"])
    got = st.gather(st.snapshot(), inp["sl"].astype(np.int32))
    js = JStore(120, 8, shards=8, payload_dtype=dt)
    js.scatter(inp["sl"], inp["rows"])
    want = np.asarray(js.gather(js.snapshot(), jnp.asarray(inp["sl"])))
    np.testing.assert_array_equal(got.numpy(), want)
    if dt == "f32":
        np.testing.assert_array_equal(got.numpy(), inp["rows"])
    with pytest.raises(ValueError, match="tile"):
        ShardedPayloadStore(120, 8, shards=6, mesh=MESH, device="cpu")


def _hps(inp, root, **kw):
    pdb = PersistentDB(root)
    tabs = []
    for i in range(3):
        pdb.create_table("m", f"t{i}", 120, 8, initial=inp[f"table{i}"])
        tabs.append(EmbeddingTableConfig(f"t{i}", 120, 8, hotness=4,
                                         combiner="mean" if i % 2
                                         else "sum"))
    return HPS("m", tabs, pdb, cache_capacity=32, **kw)


def test_sharded_hps_on_the_mesh_matches_unsharded_and_jax(ref, tmp_path):
    inp, want, _ = ref
    h1 = _hps(inp, str(tmp_path / "n1"), device="cpu")
    h4 = _hps(inp, str(tmp_path / "n4"), cache_shards=4,
              cache_mesh=make_cache_mesh(4, devices=["cpu"] * 4))
    assert h4.device.type == "cpu" and len(h4.cache_mesh) == 4
    for k in range(QUERIES):
        cat = inp[f"cat{k}"]
        got = h4.lookup(cat)
        np.testing.assert_array_equal(got.numpy(), h1.lookup(cat).numpy())
        np.testing.assert_allclose(got.numpy(), want[f"hps_{k}"],
                                   rtol=1e-6, atol=1e-6)
    assert {k: c.hits for k, c in h1.caches.items()} == \
        {k: c.hits for k, c in h4.caches.items()}


@pytest.mark.parametrize("n,entries,cl,hole,dt", [
    (2, 2, 16, 0.0, "f32"), (4, 2, 5, 0.3, "int8"), (8, 4, 16, 0.2, "f32"),
    (8, 2, 7, 0.5, "f16"), (6, 3, 9, 0.1, "f32"), (4, 4, 1, 0.25, "int8"),
    (8, 8, 3, 0.4, "f32"), (12, 4, 6, 1.0, "f32")])
def test_owner_mapped_read_splits_by_stripe(n, entries, cl, hole, dt):
    """``hps_gather.owned_read`` over ``n`` stripes of ``cl`` rows on
    ``entries`` entries: an entry places exactly the rows of the slots in
    its own stripes (the others untouched), the entries' placed rows add
    up, in entry order, to the one-device flat read bit for bit, and the
    mesh reads (rows and a pooled H = 3 read, on this device and through
    the other-device branch) equal the one-device reads bit for bit."""
    rng = np.random.default_rng(n * 100 + entries * 10 + cl)
    rows = rng.standard_normal((n * cl, 8)).astype(np.float32)
    stripes, scales = (torch.from_numpy(rows).view(n, cl, 8), None) \
        if dt == "f32" else _quantized(rows.reshape(n, cl, 8), dt)
    if dt == "f16":
        scales = None
    slots = rng.integers(0, n * cl, size=(41, 1)).astype(np.int32)
    slots[rng.random(slots.shape) < hole] = -1
    sl = torch.from_numpy(slots)
    mesh = ["cpu"] * entries
    blocks, bsc = ops.place_stripes(stripes, scales, mesh)
    k = n // entries
    flat = ops.sharded_cache_gather(stripes, sl.view(-1), scales=scales)
    total = torch.zeros((41, 1, 8))
    for j in range(entries):
        placed = torch.full((41, 1, 8), float("nan"))
        hps_gather.owned_read([blocks[j]], None if bsc is None
                              else [bsc[j]], [sl], n, j * k, placed)
        owner = (sl >= 0) & ((sl % n) // k == j)
        written = ~placed.isnan().all(dim=-1)
        assert torch.equal(written, owner)
        assert torch.equal(placed[owner], flat[owner[:, 0]])
        total = total + torch.where(written[..., None], placed, 0.0)
    assert torch.equal(total[:, 0], flat)
    payload = ((blocks, bsc),)
    others = [True] + [False] * (entries - 1)
    for local in (None, others):
        got = ops.mesh_pooled_read(payload, [sl], local=local)
        assert torch.equal(got[:, 0], flat)
    pslots = torch.from_numpy(rng.integers(-1, n * cl, size=(9, 3)).astype(
        np.int32))
    one = ops.sharded_pooled_lookup(stripes, pslots, scales=scales)
    for local in (None, others):
        got = ops.mesh_pooled_read(payload, [pslots], local=local)
        assert torch.equal(got[:, 0], one)


@pytest.mark.parametrize("hc", ("h1", "h3"))
@pytest.mark.parametrize("dt", DTYPES)
def test_mesh_pooled_stack_matches_jax(ref, dt, hc):
    """The served pooled read of four tables (their own Cl, ``sum`` and
    ``mean``) over the cache mesh, one owner-mapped read an entry for all
    of them: the reference's stack of per-table ``sharded_pooled_lookup``
    over its four devices at 1e-6, and the one-device read of the stripes'
    flat views bit for bit (H 1, and H 3 / 1 / 3 / 2)."""
    inp, want, _ = ref
    pays = []
    for t, cl in enumerate(STACK_CL):
        r = inp[f"stack_rows{t}"].reshape(8, cl, 8)
        st, sc = (torch.from_numpy(r), None) if dt == "f32" \
            else _quantized(r, dt)
        pays.append((st, sc if dt == "int8" else None))
    slots = [torch.from_numpy(inp[f"stack_{hc}_{t}"]) for t in range(4)]
    placed = [ops.place_stripes(st, sc, MESH) for st, sc in pays]
    got = _pooled_stack(placed, slots, STACK_COMBINERS, mesh=MESH)
    one = _pooled_stack([ops.striped_view(p) for p in pays],
                        [ops.flatten_striped_slots(st, s)
                         for (st, _), s in zip(pays, slots)],
                        STACK_COMBINERS)
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    np.testing.assert_allclose(got.numpy(), want[f"stack_{dt}_{hc}"],
                               rtol=1e-6, atol=1e-6)
