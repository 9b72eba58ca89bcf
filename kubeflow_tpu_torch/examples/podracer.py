"""Podracer-style decoupled actor/learner RL: the elastic scenario.

PyTorch port of ``kubeflow_tpu/examples/podracer.py`` (PAPERS.md:
"Podracer architectures for scalable Reinforcement Learning"). An RL
workload splits into a *learner* that owns the optimizer state and a
fleet of *actor* slices that only hold a read-only copy of the policy,
so the two scale independently: actors come and go with the cluster's
weather while the learner never restarts.

- The **learner** trains the policy with REINFORCE (reward-to-go, Adam
  at ``optax.adam``'s numerics: the port's ``AdamW`` with no weight
  decay); its train state is created once and only ever advanced by
  ``apply_gradients``, so its step clock is strictly monotone.
- The **actors** run batched rollouts of a synthetic environment, each
  slice on its own devices. One process cannot hold several disjoint
  process-group meshes, so a slice is a list of this process's devices
  (``elastic/reshard.py:DeviceSlice``, from ``mesh_for_slices(1,
  devices=...)``). When the actor slice count changes (2 → 1 → 2 here:
  a shrink offer, then the capacity coming back) the pool rebuilds its
  slices and re-places the current policy through the same logical-axis
  path the checkpoint restore uses (``shard_put``): no checkpoint, the
  parameters are live.
- Learner → actor publication is the same ``shard_put`` after every
  update, so an actor joining after a resize sees the newest weights.

The device list is :data:`VIRTUAL_DEVICES` entries over the cards
there are (the reference's CPU tier has 8 virtual devices): half for the
learner, the rest for the actors, two a slice. Sampled actions follow
torch's generator, seeded per slice and iteration; they are not
``jax.random``'s.

Run: ``python -m kubeflow_tpu_torch.examples.podracer --iterations 9``
(``--device cpu`` off the card).
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.elastic.reshard import mesh_for_slices, shard_put
from kubeflow_tpu_torch.examples.common import log_metrics, setup_logging
from kubeflow_tpu_torch.train.trainer import AdamW, TrainState
from kubeflow_tpu_torch.utils.device import resolve_device

OBS_DIM = 8
N_ACTIONS = 4
HORIZON = 16
# the reference's CPU tier: half for the learner, two slices of two actors
VIRTUAL_DEVICES = 8

Params = Dict[str, torch.Tensor]


def init_policy_params(hidden: int = 32, seed: int = 0) -> Params:
    """The policy's weights from a numpy seed: each kernel normal with
    variance 1/fan_in (flax's lecun-normal scale), each bias zero."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (n_in, n_out) in (("body", (OBS_DIM, hidden)),
                                ("head", (hidden, N_ACTIONS))):
        out[f"{name}.kernel"] = torch.from_numpy(
            rng.standard_normal((n_in, n_out), dtype=np.float32)
            / np.float32(np.sqrt(n_in)))
        out[f"{name}.bias"] = torch.zeros(n_out)
    return out


def policy_apply(params: Params, obs: torch.Tensor) -> torch.Tensor:
    """The policy's forward from a parameter dict (an actor's copy, or
    the learner's own parameters)."""
    h = torch.tanh(obs @ params["body.kernel"] + params["body.bias"])
    return h @ params["head.kernel"] + params["head.bias"]


class Dense(nn.Module):
    """``flax.linen.Dense``'s parameters: ``kernel`` ``(in, out)`` and
    ``bias``."""

    def __init__(self, kernel: torch.Tensor, bias: torch.Tensor) -> None:
        super().__init__()
        self.kernel = nn.Parameter(kernel)
        self.bias = nn.Parameter(bias)


class Policy(nn.Module):
    """Tiny policy net: obs -> action logits (the reference's ``body``
    and ``head`` Dense layers, under the same names)."""

    def __init__(self, params: Params) -> None:
        super().__init__()
        self.body = Dense(params["body.kernel"], params["body.bias"])
        self.head = Dense(params["head.kernel"], params["head.bias"])

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return policy_apply(dict(self.named_parameters()), obs)


def policy_axes(path: Any, leaf: Any) -> tuple:
    """Logical axes for the policy's leaves, the workload's half of the
    reshard contract: 2-D kernels are ("embed", "mlp") (mlp rides tp
    where a mesh has one, which a slice of one process's devices does
    not); everything else replicates."""
    ndim = getattr(leaf, "ndim", 0)
    if ndim == 2:
        return ("embed", "mlp")
    return (None,) * ndim


def _env_params(seed: int = 7) -> Dict[str, np.ndarray]:
    """A fixed synthetic MDP: linear-tanh dynamics, quadratic cost,
    from a numpy seed, so every actor slice (and every run) steps the
    same world."""
    rng = np.random.default_rng(seed)
    return {
        "A": rng.standard_normal((OBS_DIM, OBS_DIM), dtype=np.float32)
        * np.float32(0.3),
        "B": rng.standard_normal((N_ACTIONS, OBS_DIM), dtype=np.float32)
        * np.float32(0.5),
    }


def _seed(*keys: int) -> int:
    """A 63-bit seed for a generator from integer keys (the reference's
    ``fold_in`` chain)."""
    return int(np.random.SeedSequence(list(keys)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def make_rollout(mesh, env: Dict[str, np.ndarray]) -> Callable[..., Any]:
    """One actor slice's rollout: ``(params, seed, s0) -> (obs, actions,
    rewards)``, each ``(HORIZON, batch, ...)``, on the slice's device."""
    device = mesh.devices[0]
    A = torch.from_numpy(env["A"]).to(device)
    B = torch.from_numpy(env["B"]).to(device)

    @torch.no_grad()
    def run(params: Params, seed: int, s0: torch.Tensor):
        gen = torch.Generator(device=device).manual_seed(seed)
        s = s0.to(device)
        obs, acts, rews = [], [], []
        for _ in range(HORIZON):
            probs = torch.softmax(policy_apply(params, s), dim=-1)
            a = torch.multinomial(probs, 1, generator=gen)[:, 0]
            s2 = torch.tanh(s @ A + nn.functional.one_hot(
                a, N_ACTIONS).to(s.dtype) @ B)
            obs.append(s)
            acts.append(a)
            rews.append(-(s2 * s2).sum(-1))
            s = s2
        return torch.stack(obs), torch.stack(acts), torch.stack(rews)

    return run


def make_update() -> Callable[..., Any]:
    """The learner's policy-gradient step (REINFORCE with reward-to-go):
    ``(state, obs, acts, rews) -> (state, metrics)``, on the device of
    the state's parameters."""

    def update(state: TrainState, obs, acts, rews):
        dev = state.device
        obs = torch.as_tensor(obs, device=dev)
        acts = torch.as_tensor(acts, device=dev).long()
        rews = torch.as_tensor(rews, device=dev)
        rtg = torch.flip(torch.cumsum(torch.flip(rews, [0]), 0), [0])
        rtg = rtg - rtg.mean()
        logp = torch.log_softmax(state.module(obs), dim=-1)
        lp = logp.gather(-1, acts[..., None])[..., 0]
        loss = -(lp * rtg).mean()
        grads = torch.autograd.grad(loss, state.params)
        state.apply_gradients(grads)
        return state, {"loss": loss.detach(), "reward": rews.mean(),
                       "step": state.step}

    return update


def make_adam(learning_rate: float) -> AdamW:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8, no
    weight decay, no clipping, a constant rate."""
    return AdamW(learning_rate=learning_rate, weight_decay=0.0)


class ActorPool:
    """The elastically scaled half: N independent actor slices, each on
    its own devices. ``scale(n)`` is the resize path (rebuild the slices
    with ``mesh_for_slices``, re-place the live policy with
    ``shard_put``) and never touches the learner."""

    def __init__(self, devices: Sequence[Any], env: Dict[str, np.ndarray],
                 *, devices_per_slice: int = 2) -> None:
        self.devices = list(devices)
        self.env = env
        self.devices_per_slice = devices_per_slice
        self.max_slices = len(self.devices) // devices_per_slice
        self.meshes: List[Any] = []
        self.rollouts: List[Callable[..., Any]] = []
        self.params: List[Params] = []
        self.resizes = 0

    @property
    def n_slices(self) -> int:
        return len(self.meshes)

    def scale(self, n: int) -> None:
        """Resize the actor fleet to ``n`` slices (the elastic event):
        each slice is rebuilt and the CURRENT policy re-placed through
        the logical-axis reshard path."""
        if not 1 <= n <= self.max_slices:
            raise ValueError(
                f"actor slices must be in [1, {self.max_slices}], got {n}")
        live = self.params[0] if self.params else None
        per = self.devices_per_slice
        self.meshes = [
            mesh_for_slices(1, devices=self.devices[i * per:(i + 1) * per])
            for i in range(n)]
        self.rollouts = [make_rollout(m, self.env) for m in self.meshes]
        self.params = ([] if live is None else
                       [shard_put(live, m, axes_fn=policy_axes)
                        for m in self.meshes])
        self.resizes += 1

    def publish(self, params: Params) -> None:
        """Learner -> actors weight push, through the same reshard
        placement (a fresh actor slice and a long-lived one get
        identical copies)."""
        self.params = [shard_put(params, m, axes_fn=policy_axes)
                       for m in self.meshes]

    def collect(self, seed: int, envs_per_actor: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One round of rollouts across every live actor slice, on the
        host; trajectories concatenate on the batch axis for the
        learner."""
        obs, acts, rews = [], [], []
        for i, run in enumerate(self.rollouts):
            s0 = np.random.default_rng(_seed(seed, i, 1)).standard_normal(
                (envs_per_actor, OBS_DIM), dtype=np.float32)
            o, a, r = run(self.params[i], _seed(seed, i, 2),
                          torch.from_numpy(s0))
            obs.append(o.cpu())
            acts.append(a.cpu())
            rews.append(r.cpu())
        return (torch.cat(obs, 1), torch.cat(acts, 1), torch.cat(rews, 1))


def virtual_devices(device, n: int) -> List[torch.device]:
    """``n`` devices over the cards there are (round robin), or ``n``
    times the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=9)
    p.add_argument("--envs-per-actor", type=int, default=4)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--learner-devices", type=int, default=None,
                   help="devices for the learner (default: half)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    setup_logging()
    devs = virtual_devices(args.device, VIRTUAL_DEVICES)
    n_learner = (args.learner_devices if args.learner_devices
                 else max(len(devs) // 2, 1))
    learner_devs = devs[:n_learner]
    actor_devs = devs[n_learner:] or devs[:1]

    env = _env_params()
    learner_mesh = mesh_for_slices(1, devices=learner_devs)
    params = shard_put(init_policy_params(args.hidden), learner_mesh,
                       axes_fn=policy_axes)
    state = TrainState.create(Policy(params), make_adam(args.learning_rate))
    update = make_update()

    def live() -> Params:
        return dict(state.module.named_parameters())

    pool = ActorPool(actor_devs, env)
    pool.scale(min(2, pool.max_slices))
    pool.publish(live())
    initial_resizes = pool.resizes

    # the elastic schedule: shrink the actor fleet mid-run (a scheduler
    # shrink offer), then grow it back (capacity returned): 2 -> 1 -> 2
    third = max(args.iterations // 3, 1)
    schedule = {third: 1, 2 * third: min(2, pool.max_slices)}

    steps_seen: List[int] = []
    last_reward = 0.0
    for it in range(1, args.iterations + 1):
        target = schedule.get(it)
        if target is not None and target != pool.n_slices:
            pool.scale(target)
            pool.publish(live())
            log_metrics(it, actor_slices=pool.n_slices,
                        event="actor_resize")
        obs, acts, rews = pool.collect(_seed(42, it), args.envs_per_actor)
        state, metrics = update(state, obs, acts, rews)
        pool.publish(live())
        steps_seen.append(int(metrics["step"]))
        last_reward = float(metrics["reward"])
        log_metrics(it, loss=metrics["loss"], reward=last_reward,
                    actor_slices=pool.n_slices,
                    learner_step=int(metrics["step"]))

    # the Podracer acceptance: the learner never restarted; its step
    # clock advanced exactly once per iteration while the actor fleet
    # resized around it
    monotone = all(b == a + 1 for a, b in zip(steps_seen, steps_seen[1:]))
    return {
        "learner_steps": steps_seen[-1] if steps_seen else 0,
        "learner_monotone": monotone,
        "actor_resizes": pool.resizes - initial_resizes,
        "actor_slices": pool.n_slices,
        "last_reward": last_reward,
    }


if __name__ == "__main__":
    main()
