"""Serving and evaluation over the ``data`` axis of a mesh in one process
(``parallel/mesh.py``, ``pipeline.make_sharded_pipeline``,
``train/state.make_sharded_eval_step``) against the JAX package's mesh
programs on the conftest's 8 host devices, as
``tests/test_sharded_serving.py`` runs them.

torch has one CPU device, so a CPU mesh lists it once per shard; each
shard then runs eagerly with its own replica.  Tolerances:
- every shard ``torch.equal`` to ``make_jitted_pipeline`` (or
  ``eval_step``) on its slice: the same program on the same inputs;
- poses against JAX's sharded ``infer_poses`` on JAX's RANSAC masks:
  rotation within 1e-3 rad, translation within 1e-3 relative
  (``test_torch_pipeline.py::test_pose_agreement``);
- the sharded eval step against JAX's: heatmaps atol 1e-5, loss rtol 1e-5
  (``test_torch_train.py::test_eval_step_uses_frozen_statistics``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from esa_pose_estimation_tpu import pipeline as jpipe
from esa_pose_estimation_tpu.data import synthetic as jsyn
from esa_pose_estimation_tpu.models import HRNet as JaxHRNet
from esa_pose_estimation_tpu.ops import pnp as jpnp
from esa_pose_estimation_tpu.parallel import make_mesh as jax_make_mesh
from esa_pose_estimation_tpu.parallel import replicate as jax_replicate
from esa_pose_estimation_tpu.parallel import shard_batch as jax_shard_batch
from esa_pose_estimation_tpu.train import loss as jloss
from esa_pose_estimation_tpu.train import state as jstate
from esa_pose_estimation_tpu.utils import config as jcfg
from esa_pose_estimation_tpu_torch import pipeline as tpipe
from esa_pose_estimation_tpu_torch.core import camera
from esa_pose_estimation_tpu_torch.models.hrnet import HRNet
from esa_pose_estimation_tpu_torch.ops import pnp as tpnp
from esa_pose_estimation_tpu_torch.parallel import mesh as tmesh
from esa_pose_estimation_tpu_torch.train import state as tstate
from esa_pose_estimation_tpu_torch.utils import config as tcfg
from esa_pose_estimation_tpu_torch.utils.artifact import to_jax_variables


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    """One torch thread for this file's tests: the suite runs beside other
    workers on few cores, where more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CPU = torch.device('cpu')
N_FRAMES, N_KP, N_HYP, LM_ITERS, CROP = 16, 6, 8, 3, 64
KW = dict(crop_size=CROP, n_hypotheses=N_HYP, lm_iters=LM_ITERS)


def T(a):
    return torch.from_numpy(np.array(a))


def _angle(Ra, Rb):
    c = (np.einsum('bij,bij->b', Ra, Rb) - 1.0) / 2.0
    return np.arccos(np.clip(c, -1.0, 1.0))


def _tiny_model() -> HRNet:
    """hrnet_tiny with the port's Flax-statistics initialisers (drawing
    JAX's own ``model.init`` costs a compile of its own)."""
    return HRNet(tcfg.hrnet_tiny()).init_weights(
        torch.Generator().manual_seed(0)).eval()


def _noise_frames(n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """n noise frames of 256x256 and a box each, from a numpy seed."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(0, 255, size=(n, 256, 256)).astype(np.float32)
    lo = rng.uniform(0, 60, size=(n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(120, 190, (n, 1))],
                           -1).astype(np.float32)
    return T(frames), T(boxes)


@pytest.fixture(scope='module')
def jax_serving():
    """JAX's ``infer_poses`` jitted with ``in_shardings=(rep, dat, dat,
    rep)`` over the 8-device mesh (tests/test_sharded_serving.py:16-41)
    on hrnet_tiny's weights, with the hypothesis masks its RANSAC drew.

    A random net's keypoints fit no pose, and 3 LM iterations from such a
    fit move by 6e-3 rad for keypoints 8e-6 px apart (both packages alike),
    so the pose comparison needs a problem with a solution: one noise
    frame and box, 16 times, and keypoint-model points placed on the rays
    of the net's own 6 keypoints at depths 10-12.5 m in front of a camera
    at 10 m (true pose: identity, t = (0, 0, 10))."""
    frames, boxes = _noise_frames(1, 1)
    frames, boxes = frames.expand(N_FRAMES, -1, -1), boxes.expand(
        N_FRAMES, -1)
    model = _tiny_model()
    kp = tpipe.infer_poses(model, frames[:1], boxes[:1],
                           torch.zeros(N_KP, 3), **KW).keypoints_2d[0]
    rays = (torch.cat([kp, torch.ones(N_KP, 1)], -1).double()
            @ torch.linalg.inv(camera.speed_k(torch.float64)).T)
    depth = 10.0 + 0.5 * torch.arange(N_KP, dtype=torch.float64)
    pts = (rays * depth[:, None] / rays[:, 2:]
           - torch.tensor([0.0, 0.0, 10.0], dtype=torch.float64)).float()
    mesh = jax_make_mesh(8)
    rep = NamedSharding(mesh, P())
    dat = NamedSharding(mesh, P('data'))
    jm = JaxHRNet(jcfg.hrnet_tiny())
    key = jax.random.PRNGKey(1)
    fn = jax.jit(lambda v, f, b, k: jpipe.infer_poses(
        jm, v, f, b, jnp.asarray(pts.numpy()), k, **KW),
        in_shardings=(rep, dat, dat, rep))
    jout = fn(jax.device_put(to_jax_variables(model), rep),
              jax.device_put(frames.numpy(), dat),
              jax.device_put(boxes.numpy(), dat), key)
    assert len(jout.trans.sharding.device_set) == 8
    masks = jpnp._sample_masks(key, (N_FRAMES,), N_KP, N_HYP, 6,
                               jout.selected)
    return (frames, boxes, model, pts, T(np.asarray(masks)),
            jax.tree.map(np.asarray, jout))


def test_make_mesh_rejects_what_jax_rejects():
    """The JAX rules (tests/test_sharded_serving.py:103) with the same
    messages, on 8 listed devices as JAX's 8; then what the port adds."""
    eight = [CPU] * 8
    for kw in (dict(n_data=2, n_model=2), dict(n_data=3),
               dict(n_model=3), dict(n_model=9)):
        with pytest.raises(ValueError) as port:
            tmesh.make_mesh(devices=eight, **kw)
        with pytest.raises(ValueError) as jax_err:
            jax_make_mesh(**kw)
        assert str(port.value) == str(jax_err.value), kw
    assert str(port.value) == 'n_model=9 with 8 devices'
    with pytest.raises(NotImplementedError, match='spans processes, one '
                                                  'per card'):
        tmesh.make_mesh(n_data=2, n_model=2, devices=eight[:4])
    assert jax_make_mesh(n_data=2, n_model=2,
                         devices=jax.devices()[:4]).devices.shape == (2, 2)
    mesh = tmesh.make_mesh(devices=eight)
    assert mesh.devices == (CPU,) * 8 and mesh.shape == {'data': 8,
                                                         'model': 1}
    with pytest.raises(ValueError, match='does not divide'):
        tmesh.shard_batch(torch.zeros(12, 3), mesh)
    with pytest.raises(ValueError, match='mixed device types'):
        tmesh.make_mesh(devices=[CPU, torch.device('cuda', 0)])


def test_shard_batch_lays_out_like_jax():
    """Contiguous slices of the leading axis in device order, as JAX's
    ``P('data')`` places them on its 8 devices; gather inverts it."""
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    mesh = tmesh.make_mesh(devices=[CPU] * 8)
    got = tmesh.shard_batch({'x': T(x), 'y': (T(x[:, 0]),)}, mesh)
    jmesh = jax_make_mesh(8)
    jx = jax_shard_batch(x, jmesh)
    order = list(jmesh.devices.flat)
    for w in jx.addressable_shards:
        shard = got.shards[order.index(w.device)]
        np.testing.assert_array_equal(shard['x'].numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(shard['y'][0].numpy(),
                                      np.asarray(w.data)[:, 0])
    back = got.gather()
    assert torch.equal(back['x'], T(x)) and torch.equal(back['y'][0],
                                                        T(x[:, 0]))


def test_replicas_are_bit_equal_and_separate():
    model = _tiny_model()
    reps = tmesh.replicate(model, tmesh.make_mesh(devices=[CPU] * 2))
    assert len(reps) == 2 and reps[0] is not reps[1]
    for r in reps:
        for (k, a), b in zip(model.state_dict().items(),
                             r.state_dict().values()):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), k


@pytest.mark.parametrize('n_shards', [8, 4])
def test_each_shard_equals_the_jitted_pipeline(n_shards):
    """Every shard torch.equal to make_jitted_pipeline on its slice with
    its slice of the global draw (samples of 4 of the 6 keypoints, so the
    draw decides the hypotheses); the generator left as one unsharded call
    leaves it."""
    frames, boxes = _noise_frames(N_FRAMES, 0)
    model = _tiny_model()
    pts = T(jsyn.spacecraft_points(N_KP))
    kw = dict(KW, sample_size=4)
    mesh = tmesh.make_mesh(devices=[CPU] * n_shards)
    gen = torch.Generator().manual_seed(5)
    out = tpipe.make_sharded_pipeline(model, pts, mesh, **kw)(frames, boxes,
                                                               gen)
    assert len(out.shards) == n_shards
    ref_gen = torch.Generator().manual_seed(5)
    uniforms = tpnp.draw_ransac_uniforms(ref_gen, (N_FRAMES,), N_KP, N_HYP)
    whole = tpipe.make_jitted_pipeline(model, pts, **kw)
    whole_gen = torch.Generator().manual_seed(5)
    whole_out = whole(frames, boxes, whole_gen)
    assert torch.equal(gen.get_state(), whole_gen.get_state())
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    for sl, shard in zip(tmesh.batch_sharding(mesh, N_FRAMES), out.shards):
        want = whole(frames[sl], boxes[sl], ransac_uniforms=uniforms[sl])
        for name, a, b in zip(want._fields, shard, want):
            assert torch.equal(a, b), name
    gathered = out.gather()
    assert gathered.quat.shape == (N_FRAMES, 4)
    assert torch.isfinite(gathered.trans).all()
    # the unsharded call on the same draw: the same keypoints (its network
    # sums over 16 frames, a shard's over 16 // n_shards)
    np.testing.assert_allclose(gathered.keypoints_2d.numpy(),
                               whole_out.keypoints_2d.numpy(), atol=1e-4)


def test_poses_match_jax_sharded_serving(jax_serving):
    """JAX's masks injected: the gathered poses within 1e-3 rad and 1e-3
    relative translation of JAX's sharded infer_poses, the selections and
    crops equal."""
    frames, boxes, model, pts, masks, jout = jax_serving
    mesh = tmesh.make_mesh(devices=[CPU] * 8)
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    out = tpipe.make_sharded_pipeline(model, pts, mesh, ransac_masks=masks,
                                      **KW)(frames, boxes, gen)
    assert torch.equal(gen.get_state(), state)   # the masks draw nothing
    got = out.gather()
    np.testing.assert_array_equal(got.selected.numpy(), jout.selected)
    np.testing.assert_array_equal(got.origins.numpy(), jout.origins)
    np.testing.assert_allclose(got.keypoints_2d.numpy(), jout.keypoints_2d,
                               atol=1e-3)
    assert _angle(got.R.numpy(), jout.R).max() <= 1e-3
    rel = (np.linalg.norm(got.trans.numpy() - jout.trans, axis=-1)
           / np.linalg.norm(jout.trans, axis=-1))
    assert rel.max() <= 1e-3, rel
    # the problem has a solution, and both packages find it
    assert _angle(jout.R, np.eye(3)[None]).max() <= 1e-3
    np.testing.assert_allclose(jout.trans, [[0.0, 0.0, 10.0]] * N_FRAMES,
                               atol=1e-2)


def test_sharded_eval_step_matches_jax():
    """make_sharded_eval_step over 8 CPU shards against JAX's on
    make_mesh(8) (tests/test_sharded_serving.py:44-66): heatmaps per
    shard and gathered, and the loss every shard holds; each shard
    torch.equal to eval_step on its slice."""
    model = _tiny_model()
    batch = jsyn.make_batch(jax.random.PRNGKey(1), 16,
                            jsyn.spacecraft_points(N_KP), crop_size=32)
    batch = {k: np.array(batch[k]) for k in ('heatmaps', 'weights')}
    batch['image'] = np.random.default_rng(3).normal(
        size=(16, 32, 32, 1)).astype(np.float32)
    jmesh = jax_make_mesh(n_data=8, n_model=1)
    jm = JaxHRNet(jcfg.hrnet_tiny())
    variables = to_jax_variables(model)
    jst = jstate.TrainState.create(apply_fn=jm.apply,
                                   params=variables['params'],
                                   batch_stats=variables['batch_stats'],
                                   tx=optax.adam(1e-3))
    jout, jl = jstate.make_sharded_eval_step(jmesh)(
        jax_replicate(jst, jmesh), jax_shard_batch(batch, jmesh))
    assert len(jout.sharding.device_set) == 8
    mesh = tmesh.make_mesh(devices=[CPU] * 8)
    tb = {k: T(v) for k, v in batch.items()}
    heatmaps, losses = tstate.make_sharded_eval_step(mesh)(
        tmesh.replicate(model, mesh), tb)
    np.testing.assert_allclose(heatmaps.gather().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=0)
    want = float(jloss.weighted_heatmap_loss(
        jout, jnp.asarray(batch['heatmaps']), jnp.asarray(batch['weights'])))
    assert float(jl) == pytest.approx(want, rel=1e-6)
    assert len(losses) == 8 and all(torch.equal(l, losses[0])
                                    for l in losses)
    assert float(losses[0]) == pytest.approx(float(jl), rel=1e-5)
    st = tstate.TrainState(model)
    for sl, shard in zip(tmesh.batch_sharding(mesh, 16), heatmaps.shards):
        out, _ = tstate.eval_step(st, {k: v[sl] for k, v in tb.items()})
        assert torch.equal(shard, out)
