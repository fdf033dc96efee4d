"""The serving mesh of the PyTorch port on the CPU: `SynthesisModule` with
a mesh of two CPU devices (a replica each; they are one device here, so
the replicas are one) against the single-device module within 1e-6, and
against the JAX package's module on `create_mesh(2)` of its forced host
devices, within JAX's own bar for a mesh (atol 5e-4,
tests/test_infer.py:277). The module, config and buckets are
tests/test_torch_port_serve.py's; the comparisons with JAX are
noise-free (the packages draw different noise), the port's own with
noise, which the mesh draws once for the whole batch.

oneDNN's transposed convolution on the CPU blocks its work by batch, so a
row decoded in a batch of 4 or of 8 can differ by ~2e-7 at a few hundred
frames, which can flip an int16 rounding by one step (1/32767):
`synthesize_batch`, which returns int16 audio, is held within 1e-6 with
oneDNN off (torch's own convolutions compute each row alone), and within
one int16 step plus 1e-6 with it on."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from mb_istft_vits_torch.config import Config as TorchConfig
from mb_istft_vits_torch.infer import synthesis as port
from mb_istft_vits_torch.parallel import create_mesh, shard_batch
from mb_istft_vits_tpu.config import Config as JaxConfig
from mb_istft_vits_tpu.infer import synthesis as ref
from mb_istft_vits_tpu.parallel import create_mesh as jax_create_mesh

from torch_port_data import write_tiny_config
from tests.test_torch_port_serve import TEXT, _fresh, _shrink
from tests.torch_port_common import make_weights

TEXTS = ["həlˈoʊ wˈɜːld.", "ðə kwˈɪk bɹˈaʊn.", "ɐ ɡˈʊd dˈeɪ."]
MESH_TOL = 1e-6  # the same arithmetic on fewer rows
JAX_MESH_ATOL = 5e-4
CHUNKS = dict(chunk_frames=16, overlap_frames=4)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process, as in the ranks it starts: the
    suite's workers share the cores, and eight threads a worker stall on
    every small op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def modules(tmp_path_factory):
    """{"single", "mesh" (the port's), "jax_mesh"} on one tiny .pth."""
    d = tmp_path_factory.mktemp("mesh_serve")
    path = write_tiny_config(str(d))
    make_weights(d, TorchConfig.from_json(path).model,
                 JaxConfig.from_json(path).model)
    pth = str(d / "G_0.pth")
    return {
        "single": _shrink(port.SynthesisModule(path, pth, device="cpu")),
        "mesh": _shrink(port.SynthesisModule(
            path, pth, mesh=create_mesh(2, "cpu"), device="cpu")),
        "jax_mesh": _shrink(ref.SynthesisModule(
            path, checkpoint_path=pth, mesh=jax_create_mesh(2))),
    }


@pytest.fixture(scope="module")
def z(modules):
    m = modules["jax_mesh"]
    _fresh(m)
    return m.synthesize_with_z(TEXT, noise_scale=0.0, seed=0)[1]


def test_mesh_keeps_a_replica_per_position(modules):
    mesh = modules["mesh"]
    assert len(mesh.mesh) == len(mesh._replicas) == 2
    # one device twice: the positions share its replica
    assert mesh._replicas[0][1] is mesh._replicas[1][1] is mesh.model


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_batch_bucket_is_mesh_divisible_as_in_jax(modules, n_dev):
    m = modules["single"]
    m._replicas = m._replicas[:1] * n_dev
    try:
        got = [m._batch_bucket(k) for k in range(0, 41)]
    finally:
        m._replicas = m._replicas[:1]
    fake = types.SimpleNamespace(
        mesh=types.SimpleNamespace(size=n_dev) if n_dev > 1 else None,
        BATCH_BUCKETS=ref.SynthesisModule.BATCH_BUCKETS)
    want = [ref.SynthesisModule._batch_bucket(fake, k) for k in range(0, 41)]
    assert got == want
    assert all(b % n_dev == 0 and b >= max(k, 1)
               for k, b in zip(range(0, 41), got))


@pytest.mark.parametrize("noise_scale,onednn", [(0.667, False),
                                                (0.0, True)])
def test_synthesize_batch_mesh_equals_single(modules, noise_scale, onednn):
    """Three lines (a bucket of 4: two rows a replica), seeded noise drawn
    once for the batch: each row's audio is the single module's."""
    kw = dict(noise_scale=noise_scale, seed=5)
    with torch.backends.mkldnn.flags(enabled=onednn):
        want, _ = modules["single"].synthesize_batch(TEXTS, **kw)
        got, timings = modules["mesh"].synthesize_batch(TEXTS, **kw)
    assert len(got) == len(want) == 3
    atol = MESH_TOL + (1 / 32767 if onednn else 0.0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)
    assert timings["utterances_per_sec"] > 0


def test_synthesize_batch_mesh_matches_jax_mesh(modules):
    got, _ = modules["mesh"].synthesize_batch(TEXTS, noise_scale=0.0)
    want, _ = modules["jax_mesh"].synthesize_batch(TEXTS, noise_scale=0.0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=JAX_MESH_ATOL)


def _decode(m, path, z):
    if path == "decode_spec_join":
        return m.decode_spec_join(z, batched=True, **CHUNKS)
    return m.decode_chunks_batched(z, **CHUNKS)


@pytest.mark.parametrize("path", ["decode_chunks_batched",
                                  "decode_spec_join"])
@pytest.mark.parametrize("against", ["single", "jax_mesh"])
def test_chunked_decodes_on_the_mesh(modules, z, path, against):
    """The chunk batch of one latent split over the mesh: the single
    module's audio (1e-6) and JAX's mesh module's (atol 5e-4)."""
    got = _decode(modules["mesh"], path, z)
    want = _decode(modules[against], path, z)
    assert got.shape == want.shape == (len(z) * 256,)
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=MESH_TOL if against == "single" else JAX_MESH_ATOL)


def test_shard_batch_splits_rows_evenly_over_the_mesh():
    """`parallel.shard_batch`, which the module's fan-out uses: part i is
    rows [i * B/n:(i + 1) * B/n] on device i, through dicts and tuples,
    None passing through; rows that do not split evenly raise."""
    batch = {"x": torch.arange(12).reshape(6, 2), "sid": None,
             "pair": (torch.arange(6), torch.ones(6, 3))}
    parts = shard_batch(batch, create_mesh(3, "cpu"))
    assert len(parts) == 3
    for i, part in enumerate(parts):
        assert part["sid"] is None
        assert torch.equal(part["x"], batch["x"][2 * i:2 * i + 2])
        assert torch.equal(part["pair"][0], torch.arange(2 * i, 2 * i + 2))
        assert part["pair"][1].shape == (2, 3)
    with pytest.raises(ValueError, match="do not split"):
        shard_batch(batch, create_mesh(4, "cpu"))
