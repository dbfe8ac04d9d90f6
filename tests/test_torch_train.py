"""The port's depth trainer against the JAX package's, on the CPU.

- ``ssi_align`` and ``ssi_loss`` on seeded data, with and without a mask:
  within 1e-6 of the JAX functions (relative to the value); an affine
  image of the target has (nearly) zero loss, as the JAX test checks.
- Three AdamW steps of ``DA_TINY`` at 28^2 on one seeded batch of 2, from
  the same weights (the port's seeded init, given to JAX through
  ``to_jax_params``), against the JAX ``Trainer``'s loss and optimizer
  with no mesh: each loss within 1e-4 relative; the first step's gradient
  within 1e-4 x max |g|; the parameters after the steps with a mean |d|
  (over every parameter value) within 1e-2 x lr. The maximum is not
  gated: Adam's first step is about sign(g), so a component whose
  gradient is nearly zero (the key biases, which softmax ignores) may move
  either way with the summation order.
- Two ranks under ``gloo`` (spawned, the CPU), each on its half of a batch
  of 4, against the single-process steps on the whole batch: each loss
  within 1e-5 relative, the first averaged gradient within 1e-5 x max |g|,
  the parameters after two steps with a mean |d| within 1e-2 x lr; JAX's
  ``dp=2`` trainer on two virtual CPU devices gives the first loss within
  1e-4.
- The state dict round-trips; a mesh with sp raises ValueError (the JAX
  trainer shards no rows); with the K7 opt-in a step raises (K7 has no
  backward); a step
  after an inference call of the same shapes runs (the cached resize
  matrices are normal tensors).
- ``tp=2`` on [cpu, cpu] (the ViT's attention and MLP blocks split
  Megatron-style, ``parallel/tp.py``) against one device from the same
  weights, after one step: the loss within 1e-5 relative and every
  gradient within 1e-5 x max |g| (compared under the unsharded names);
  a second step's loss too, and the weights after it with a mean |d|
  within 1e-2 x lr.
- On a card (``cuda`` marker): one step on the card against the CPU.
"""

from __future__ import annotations

import socket

import numpy as np
import pytest
import torch
torch.set_num_threads(1)
import torch.distributed as dist
import torch.multiprocessing as mp

from visiondepth3d_tpu_torch.depth import configs as tconfigs
from visiondepth3d_tpu_torch.ops import attention as tattention
from visiondepth3d_tpu_torch.parallel import make_mesh
from visiondepth3d_tpu_torch.train import Trainer, ssi_align, ssi_loss

S, LR = 28, 1e-3


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, S, S, 3), dtype=np.float32),
            rng.random((n, S, S), dtype=np.float32))


def _jax_twin(trainer):
    """The JAX package's Trainer and its params on ``trainer``'s weights
    (``to_jax_params``: no JAX init to trace)."""
    import jax
    import jax.numpy as jnp
    from visiondepth3d_tpu.depth.configs import DA_TINY
    from visiondepth3d_tpu.train import Trainer as JTrainer
    from visiondepth3d_tpu_torch.depth.convert import to_jax_params

    jt = JTrainer(DA_TINY, learning_rate=LR)
    state = {k: v.detach().numpy().copy() for k, v in trainer.module.state_dict().items()}
    return jt, jax.tree.map(jnp.asarray, to_jax_params("dpt_dinov2", state, tconfigs.DA_TINY))


def _to_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _state(trainer):
    return {k: v.detach().float().clone() for k, v in trainer.module.state_dict().items()}


def _grads(trainer):
    return {k: p.grad.detach().clone() for k, p in trainer.module.named_parameters()}


def _mean_abs_diff(a: dict, b: dict) -> float:
    total = sum(float((a[k].float() - b[k].float()).abs().sum()) for k in a)
    return total / sum(a[k].numel() for k in a)


def _max_rel(a: dict, b: dict) -> float:
    """max |a - b| over every value, over max |b|."""
    top = max(float(v.abs().max()) for v in b.values())
    return max(float((a[k] - b[k]).abs().max()) for k in a) / top


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("masked", [False, True])
def test_ssi_align_and_loss_match_jax(masked):
    import jax
    import jax.numpy as jnp
    from visiondepth3d_tpu.train import ssi_align as jalign
    from visiondepth3d_tpu.train import ssi_loss as jloss

    jalign, jloss = jax.jit(jalign), jax.jit(jloss, static_argnums=(3, 4))  # one compile each
    rng = np.random.default_rng(3)
    pred = rng.random((3, 20, 24), dtype=np.float32)
    target = rng.random((3, 20, 24), dtype=np.float32)
    mask = (rng.random((3, 20, 24)) > 0.3).astype(np.float32) if masked else None
    m = mask if masked else np.ones_like(target)
    got = ssi_align(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(m))
    want = np.asarray(jalign(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(m)))
    # the closed form's sums run over 480 pixels in another order than XLA's, and
    # its determinant cancels: 2.3e-6 of the largest value was measured with the
    # mask, so the aligned maps are held to 5e-6 of it (the loss to 1e-6)
    err = np.abs(got.numpy() - want).max()
    assert err <= 5e-6 * np.abs(want).max(), err
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    for gw, scales in ((0.5, 4), (0.0, 1), (1.0, 2)):
        got = float(ssi_loss(torch.from_numpy(pred), torch.from_numpy(target), tm, gw, scales))
        want = float(jloss(jnp.asarray(pred), jnp.asarray(target), jm, gw, scales))
        assert abs(got - want) <= 1e-6 * abs(want), (gw, scales, got, want)


def test_ssi_loss_invariance():
    target = torch.from_numpy(np.random.default_rng(0).random((2, 32, 32), dtype=np.float32))
    assert float(ssi_loss(target * 3.7 - 1.2, target, grad_weight=0.0)) < 1e-9


# ------------------------------------------------------------------ steps

def test_three_steps_match_jax():
    import jax
    import jax.numpy as jnp
    import optax
    from visiondepth3d_tpu.train import ssi_loss as jloss
    from visiondepth3d_tpu_torch.depth.convert import from_jax_params

    frames, targets = _batch(2)
    trainer = Trainer(tconfigs.DA_TINY, learning_rate=LR, device="cpu").init(
        torch.Generator().manual_seed(0))
    jt, params = _jax_twin(trainer)
    opt = jt.tx.init(params)

    def loss_fn(p):
        return jloss(jt.model.apply({"params": p}, jnp.asarray(frames)), jnp.asarray(targets))

    # the JAX Trainer's train step, with its gradient kept: value_and_grad of
    # its model's loss, then its optimizer's update (one compile each)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))

    @jax.jit
    def update(grad, opt, params):
        updates, opt = jt.tx.update(grad, opt, params)
        return optax.apply_updates(params, updates), opt

    for i in range(3):
        jl, jgrad = value_and_grad(params)
        params, opt = update(jgrad, opt, params)
        loss = trainer.step(frames, targets)
        assert abs(loss - float(jl)) <= 1e-4 * abs(float(jl)), (i, loss, float(jl))
        if i == 0:
            grads = _grads(trainer)
            want = from_jax_params(_to_np(jgrad), tconfigs.DA_TINY)
            assert _max_rel(grads, {k: want[k] for k in grads}) <= 1e-4
    want = from_jax_params(_to_np(params), tconfigs.DA_TINY)
    got = _state(trainer)
    assert _mean_abs_diff(got, {k: want[k] for k in got}) <= 1e-2 * LR


def test_state_dict_round_trip_and_refusals():
    frames, targets = _batch(2, seed=1)
    a = Trainer(tconfigs.DA_TINY, learning_rate=LR, device="cpu").init(
        torch.Generator().manual_seed(0))
    a.step(frames, targets)
    b = Trainer(tconfigs.DA_TINY, learning_rate=LR, device="cpu")
    b.load_state_dict(a.state_dict())
    assert a.step(frames, targets) == b.step(frames, targets)
    assert all(torch.equal(x, y) for x, y in zip(_state(a).values(), _state(b).values()))
    with pytest.raises(ValueError, match="shards no rows"):
        Trainer(tconfigs.DA_TINY, device="cpu").init(
            mesh=make_mesh(dp=1, sp=2, devices=["cpu", "cpu"]))
    with pytest.raises(RuntimeError, match="init"):
        Trainer(tconfigs.DA_TINY, device="cpu").step(frames, targets)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Trainer(tconfigs.DA_TINY)  # the card by default: no CPU fallback


def test_tp_two_devices_match_one_device():
    from visiondepth3d_tpu_torch.parallel.tp import TPAttention, full_state_dict

    frames, targets = _batch(2, seed=3)
    one = Trainer(tconfigs.DA_TINY, learning_rate=LR, device="cpu").init(
        torch.Generator().manual_seed(0))
    split = Trainer(tconfigs.DA_TINY, learning_rate=LR, device="cpu").init(
        torch.Generator().manual_seed(0), mesh=make_mesh(dp=1, tp=2, devices=["cpu", "cpu"]))
    assert any(isinstance(m, TPAttention) for m in split.module.modules())
    losses = [(one.step(frames, targets), split.step(frames, targets))]
    want = _grads(one)
    got = full_state_dict(split.module, grads=True)
    assert set(got) == set(want)
    assert abs(losses[0][1] - losses[0][0]) <= 1e-5 * abs(losses[0][0])
    assert _max_rel(got, want) <= 1e-5
    losses.append((one.step(frames, targets), split.step(frames, targets)))
    assert abs(losses[1][1] - losses[1][0]) <= 1e-5 * abs(losses[1][0])
    state = {k: v.float() for k, v in full_state_dict(split.module).items()}
    assert _mean_abs_diff(state, _state(one)) <= 1e-2 * LR


def test_step_after_inference_in_one_process():
    """The resize matrices are cached per shape: made first under inference
    mode (a render or the depth route) they must still serve a training
    step of the same shapes."""
    from visiondepth3d_tpu_torch.ops import resize

    resize._matrix.cache_clear()
    trainer = Trainer(tconfigs.DA_TINY, device="cpu").init()
    frames, targets = _batch(1, seed=7)
    with torch.inference_mode():
        trainer.module.eval()(torch.from_numpy(frames).permute(0, 3, 1, 2))
    assert np.isfinite(trainer.step(frames, targets))


def test_k7_opt_in_refuses_a_training_step(monkeypatch):
    """At 322^2 DA_TINY has 530 tokens, inside K7's gate: the opt-in's step
    raises rather than train through a kernel with no backward."""
    monkeypatch.setattr(tattention, "USE_VMEM_KERNEL", True)
    trainer = Trainer(tconfigs.DA_TINY, device="cpu").init()
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="no backward"):
        trainer.step(rng.random((1, 322, 322, 3), dtype=np.float32),
                     rng.random((1, 322, 322), dtype=np.float32))
    with torch.no_grad():  # inference under the opt-in still runs K7's route
        trainer.module.eval()(torch.rand(1, 3, 322, 322))


# ------------------------------------------------------------------ DDP

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ddp_rank(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        frames, targets = _batch(4, seed=2)
        trainer = Trainer(tconfigs.DA_TINY, learning_rate=LR, device="cpu").init(
            torch.Generator().manual_seed(4))
        losses = []
        for i in range(2):
            losses.append(trainer.step(frames, targets))
            if i == 0:
                grads = _grads(trainer)
        if rank == 0:  # numpy: pickled by value, not through shared memory
            out.put((losses, {k: v.numpy() for k, v in grads.items()},
                     {k: v.numpy() for k, v in _state(trainer).items()}))
    finally:
        dist.destroy_process_group()


def test_ddp_two_ranks_match_one_process():
    import jax
    import jax.numpy as jnp
    from visiondepth3d_tpu.parallel.mesh import make_mesh as jmake_mesh

    one = Trainer(tconfigs.DA_TINY, learning_rate=LR, device="cpu").init(
        torch.Generator().manual_seed(4))
    jt, params = _jax_twin(one)  # before the steps
    frames, targets = _batch(4, seed=2)
    losses = []
    for i in range(2):
        losses.append(one.step(frames, targets))
        if i == 0:
            grads = _grads(one)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_ddp_rank, args=(r, 2, port, out)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        ddp_losses, ddp_grads, ddp_state = out.get(timeout=300)
        ddp_grads = {k: torch.from_numpy(v) for k, v in ddp_grads.items()}
        ddp_state = {k: torch.from_numpy(v) for k, v in ddp_state.items()}
    finally:
        for p in procs:
            p.join(timeout=60)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    for got, want in zip(ddp_losses, losses):
        assert abs(got - want) <= 1e-5 * abs(want), (ddp_losses, losses)
    assert _max_rel(ddp_grads, grads) <= 1e-5
    assert _mean_abs_diff(ddp_state, _state(one)) <= 1e-2 * LR
    # JAX's dp=2 trainer from the same weights: the same first loss
    mesh = jmake_mesh(dp=2, devices=jax.devices()[:2])
    opt = jt.tx.init(params)
    with mesh:
        _, _, jl = jt.make_train_step(mesh)(params, opt, jnp.asarray(frames),
                                            jnp.asarray(targets))
    assert abs(float(jl) - losses[0]) <= 1e-4 * abs(losses[0])


# ------------------------------------------------------------------ card

@pytest.mark.cuda
def test_cuda_step_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        frames, targets = _batch(2, seed=5)
        out = {}
        for dev in ("cpu", "cuda"):
            t = Trainer(tconfigs.DA_TINY, learning_rate=LR, device=dev).init(
                torch.Generator().manual_seed(6))
            out[dev] = (t.step(frames, targets),
                        {k: g.cpu() for k, g in _grads(t).items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    assert _max_rel(out["cuda"][1], out["cpu"][1]) <= 1e-4
