"""The port's GPipe ``pipeline_forward`` against the JAX reference's and
the sequential forward, on the CPU (``tests/test_pipeline.py``'s cases).

The same numpy-seeded weights and inputs go through the reference's
``pipeline_forward`` on a 2-device ``("pod",)`` JAX mesh (conftest forces
8 host devices) and the port's on a 2-shard logical CPU ``Mesh``: the
outputs within 2e-5 of both, the gradients (rtol 1e-4, atol 1e-5) of the
reference's pipeline and of the sequential forward.  The schedule's
stage-boundary moves are counted as collective-permutes by
``analyze_step``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro.distributed import pipeline as RP
from repro_torch.distributed.pipeline import pipeline_forward, stack_stages
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.cost_analysis import analyze_step


def _inputs(L, B, D, seed=0):
    rng = np.random.default_rng(seed)
    ws = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return ws, x


def _jax_stage(ws_stage, h):
    def body(hh, w):
        return jnp.tanh(hh @ w), None
    return jax.lax.scan(body, h, ws_stage)[0]


def _torch_stage(ws_stage, h):
    for w in ws_stage:
        h = torch.tanh(h @ w)
    return h


def _mesh(n=2):
    return Mesh.of("cpu", (n,), ("pod",))


def _jax_mesh(n=2):
    return JaxMesh(np.array(jax.devices()[:n]).reshape(n), ("pod",))


@pytest.mark.parametrize("n_stages,L,B,D,micro", [(2, 8, 8, 16, 4),
                                                  (2, 4, 4, 8, 2),
                                                  (4, 8, 8, 16, 2)])
def test_pipeline_matches_reference_and_sequential(n_stages, L, B, D, micro):
    ws, x = _inputs(L, B, D)
    jm = _jax_mesh(n_stages)
    with jm:
        want = jax.jit(lambda p, xx: RP.pipeline_forward(
            _jax_stage, p, xx, mesh=jm, n_microbatches=micro))(
                RP.stack_stages(jnp.asarray(ws), n_stages), jnp.asarray(x))
    seq = _torch_stage(torch.from_numpy(ws), torch.from_numpy(x))
    got = pipeline_forward(_torch_stage, stack_stages(torch.from_numpy(ws),
                                                      n_stages),
                           torch.from_numpy(x), mesh=_mesh(n_stages),
                           n_microbatches=micro)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_pipeline_grads_match_reference_and_sequential():
    L, B, D = 4, 4, 8
    ws, x = _inputs(L, B, D, seed=1)
    jm = _jax_mesh()

    def loss_pipe(p):
        with jm:
            y = RP.pipeline_forward(_jax_stage, p, jnp.asarray(x), mesh=jm,
                                    n_microbatches=2)
        return jnp.sum(y ** 2)

    want = np.asarray(jax.grad(loss_pipe)(RP.stack_stages(jnp.asarray(ws),
                                                          2))).reshape(ws.shape)
    w = torch.from_numpy(ws).requires_grad_(True)
    y = pipeline_forward(_torch_stage, stack_stages(w, 2),
                         torch.from_numpy(x), mesh=_mesh(),
                         n_microbatches=2)
    (g,) = torch.autograd.grad((y ** 2).sum(), w)
    w2 = torch.from_numpy(ws).requires_grad_(True)
    (g_seq,) = torch.autograd.grad(
        (_torch_stage(w2, torch.from_numpy(x)) ** 2).sum(), w2)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), g_seq.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_pipeline_moves_and_schedule():
    """Each microbatch crosses each stage boundary once and comes back to
    the first device once; the stages run only on their microbatches (no
    bubble work): L matmuls a microbatch row block in all."""
    L, B, D, micro, n = 8, 8, 16, 4, 4
    ws, x = _inputs(L, B, D)
    cost = analyze_step(lambda: pipeline_forward(
        _torch_stage, stack_stages(torch.from_numpy(ws), n),
        torch.from_numpy(x), mesh=_mesh(n), n_microbatches=micro))
    h_bytes = (B // micro) * D * 4
    assert cost.collective_bytes == {
        "collective-permute": float(micro * (n - 1) * h_bytes
                                    + micro * h_bytes)}
    assert cost.flops == 2 * B * D * D * L
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_forward(_torch_stage, stack_stages(torch.from_numpy(ws), n),
                         torch.from_numpy(x), mesh=_mesh(n), n_microbatches=3)
    with pytest.raises(ValueError, match="stages"):
        stack_stages(torch.from_numpy(ws), 3)
