"""``layerwise_inference_uva`` (host-resident activations, dst chunks
aggregated by K6 and K7's plain versions over each chunk's CSC slice)
against the JAX package's on the same parameters and features, over
several chunks; and against the port's own full-graph pass.

Tolerance: rtol and atol 5e-3, as ``tests/test_inference.py`` and
``tests/test_torch_inference.py`` hold layerwise inference."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bliss_gnn_tpu.graph import datasets as jdata
from bliss_gnn_tpu.graph import structure as jstruct
from bliss_gnn_tpu.models import gnn as jgnn
from bliss_gnn_tpu.models import inference as jinf
from bliss_gnn_tpu.sampling import block as jblock
from bliss_gnn_tpu.sampling import samplers as jsamp

from bliss_gnn_tpu_torch import convert
from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.models import inference as tinf

torch.set_num_threads(1)

TOL = 5e-3
CONVERT = {"sage": convert.sage_params_from_jax,
           "gcn": convert.gcn_params_from_jax,
           "gat": convert.gat_params_from_jax}


@pytest.fixture(scope="module")
def graphs():
    """Both packages' canonicalised 200-node synthetic graph."""
    gj = jstruct.Graph.canonicalize(
        jdata.synthetic_graph(200, 1200, 16, 4, seed=7)[0])
    gj.edata["w"] = jstruct.normalized_edata(gj)
    gt = tstruct.Graph.canonicalize(
        tdata.synthetic_graph(200, 1200, 16, 4, seed=7)[0])
    gt.edata["w"] = tstruct.normalized_edata(gt)
    return gj, gt


def _models(gj, name, hidden, n_layers, residual):
    """A JAX model's parameters (biases made non-zero) and the port's
    model loaded with them."""
    dj = gj.to_device()
    fan = (2,) * n_layers
    plan = jblock.CapacityPlan.build(8, fan, gj.n_nodes, gj.n_edges,
                                     kind="ladies")
    blocks, _ = jsamp.sample_blocks(
        dj, jsamp.SamplerConfig(kind="ladies", fanouts=fan), plan,
        jax.random.PRNGKey(0), jnp.arange(8, dtype=jnp.int32),
        jnp.ones(8, bool))
    x = jnp.take(dj.ndata["features"].astype(jnp.float32),
                 blocks[0].src_gids, axis=0)
    kw = {"residual": residual} if name == "gat" else {}
    model_j = jgnn.build_model(name, hidden, 4, n_layers, dropout=0.0,
                               dtype=jnp.float32, **kw)
    params = model_j.init(jax.random.PRNGKey(1), blocks, x)
    params = jax.tree.map(lambda p: p + 0.01, params)
    model_t = tgnn.build_model(name, 16, hidden, 4, n_layers, device="cpu",
                               **kw)
    model_t.load_state_dict(CONVERT[name](jax.tree.map(np.asarray, params)))
    model_t.eval()
    return params, model_t


@pytest.mark.parametrize("name,hidden,n_layers,residual", [
    ("sage", 12, 2, False), ("sage", 24, 2, False), ("gcn", 12, 2, False),
    ("gcn", 24, 2, False), ("gat", 12, 2, False), ("gat", 12, 3, True)])
def test_uva_inference_matches_reference(graphs, name, hidden, n_layers,
                                         residual):
    gj, gt = graphs
    params, model_t = _models(gj, name, hidden, n_layers, residual)
    heads = (4,) * (n_layers - 1) + (1,)
    feats = np.asarray(gj.ndata["features"], np.float32)
    # node_batch 64: four chunks over the 200 nodes
    want = np.asarray(jinf.layerwise_inference_uva(
        name, params, gj, n_layers, heads=heads, residual=residual,
        dtype=jnp.float32, node_batch=64, features=feats))
    timings = {}
    got = tinf.layerwise_inference_uva(
        name, model_t, gt, n_layers, heads=heads, residual=residual,
        dtype=torch.float32, node_batch=64, features=feats, device="cpu",
        timings=timings)
    assert isinstance(got, np.ndarray) and got.shape == (gt.n_nodes, 4)
    assert timings["chunks"] == 4
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # chunked from host memory against the port's full-graph pass, in
    # bf16; in f32 with GATv2's residual, whose projection the chunked pass
    # runs in f32 (as the reference's) and the full-graph pass in bf16
    dtype = torch.float32 if residual else torch.bfloat16
    dg = tstruct.DeviceGraph.from_graph(gt, device="cpu",
                                        feature_dtype=torch.float32)
    full = tinf.layerwise_inference(name, model_t, dg, n_layers,
                                    heads=heads, residual=residual,
                                    dtype=dtype)
    chunked = tinf.layerwise_inference_uva(
        name, model_t, gt, n_layers, heads=heads, residual=residual,
        dtype=dtype, node_batch=64, features=feats, device="cpu")
    np.testing.assert_allclose(chunked, full.numpy(), rtol=TOL, atol=TOL)


def test_uva_inference_reads_a_memmap_and_one_chunk(graphs, tmp_path):
    gj, gt = graphs
    params, model_t = _models(gj, "sage", 12, 2, False)
    path = tmp_path / "feats.npy"
    np.save(path, np.asarray(gt.ndata["features"], np.float32))
    mm = np.load(path, mmap_mode="r")
    one = tinf.layerwise_inference_uva("sage", model_t, gt, 2,
                                       dtype=torch.float32, features=mm,
                                       device="cpu")
    many = tinf.layerwise_inference_uva("sage", model_t, gt, 2,
                                        dtype=torch.float32, node_batch=33,
                                        features=mm, device="cpu")
    np.testing.assert_allclose(one, many, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown model"):
        tinf.layerwise_inference_uva("mlp", model_t, gt, 2, device="cpu")
