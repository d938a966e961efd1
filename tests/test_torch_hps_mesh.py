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
  reference's sharded HPS.
"""
import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys

import numpy as np

from repro_torch.configs.base import EmbeddingTableConfig
from repro_torch.core.hps.hps import HPS
from repro_torch.core.hps.payload_store import ShardedPayloadStore
from repro_torch.core.hps.persistent_db import PersistentDB
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_cache_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = make_cache_mesh(8, devices=["cpu"] * 4)
DTYPES = ("f32", "f16", "int8")
QUERIES = 4

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
