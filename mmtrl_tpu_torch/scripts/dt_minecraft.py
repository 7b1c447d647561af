"""Offline phase: the decision transformer on Minecraft2d trajectories;
twin of ``scripts/dt_minecraft.py``.

Collect trajectories in the batched env (uniform actions, or a PPO agent
saved by ``scripts.train`` mixed with epsilon-random actions), train the
multimodal DT by return-conditioned behaviour cloning, evaluate it
conditioned on a target return.  Attention runs through the CUDA kernels
on the card.

    python -m mmtrl_tpu_torch.scripts.dt_minecraft --collect-steps 2048 --total-steps 500
    python -m mmtrl_tpu_torch.scripts.dt_minecraft --policy-from saved_agents/<run> \\
        --policy-conv-size big --policy-input-scale 255
"""

import dataclasses
import time

import torch

from mmtrl_tpu_torch.algos.dt import (
    DTTrainConfig,
    collect_trajectories,
    create_dt_state,
    evaluate_dt,
    make_dt_train_steps,
)
from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.models.decision_transformer import DTConfig
from mmtrl_tpu_torch.models.distributions import categorical_sample
from mmtrl_tpu_torch.scripts._common import device_from, field


@dataclasses.dataclass
class Args:
    exp_name: str = field("dt_minecraft", "the name of this experiment")
    seed: int = field(1, "seed of the experiment")
    torch_deterministic: bool = field(
        True, "set torch.backends.cudnn.deterministic (deterministic cuDNN algorithms)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    env_id: str = field("minecraft", "the id of the environment")
    collect_steps: int = field(4096, "rollout steps per env for the dataset")
    collect_envs: int = field(16, "parallel envs for dataset collection")
    context_len: int = field(30, "DT context length K (3K tokens)")
    d_model: int = field(512, "transformer width")
    n_layers: int = field(6, "transformer depth")
    n_heads: int = field(4, "attention heads (head_dim = d_model/n_heads)")
    dropout: float = field(0.1, "dropout rate")
    remat: bool = field(False, "recompute block activations in the backward (torch.utils.checkpoint)")
    max_timestep: int = field(64, "timestep embedding table size (> max episode len)")
    batch_size: int = field(64, "training batch size")
    learning_rate: float = field(6e-4, "peak learning rate")
    total_steps: int = field(5000, "gradient steps")
    warmup_steps: int = field(512, "LR warmup steps")
    target_return: float = field(10.0, "evaluation return-to-go conditioning")
    rtg_clip: float = field(10.0, "cap the running rtg at the data support")
    eval_greedy: bool = field(True, "argmax actions at eval (False: sample)")
    eval_envs: int = field(16, "evaluation envs")
    eval_steps: int = field(64, "evaluation env steps")
    print_interval: int = field(50, "log every n steps")
    steps_per_dispatch: int = field(1, "train steps per make_dt_train_steps call")
    save_interval: int = field(0, "save every n steps (0: never)")
    save_dir: str = field("saved_agents", "checkpoint folder")
    # Behavior policy for data collection (random if unset)
    policy_from: str = field("", "PPO checkpoint to collect trajectories with")
    policy_script: str = field("train", "entry script that produced the checkpoint")
    policy_epsilon: float = field(0.1, "random-action mixture during collection")
    policy_attn_type: str = field("casl", "behavior agent attention type")
    policy_conv_size: str = field("small", "behavior agent conv size")
    policy_input_scale: float = field(1.0, "behavior agent input scale")


def behavior_policy(args, num_actions: int, device):
    """(policy_fn, initial carry) of the PPO agent saved at
    ``--policy-from``, mixed with epsilon-random actions."""
    agent = MultimodalRecurrentAgent(
        num_actions=num_actions,
        conv_type=args.policy_conv_size,
        attn_type=args.policy_attn_type or None,
        fusion_type="sum",
        input_scale=args.policy_input_scale,
        device=device,
    )
    agent.load_state_dict(load_run(args.policy_from, map_location=device)["model"])
    eps = args.policy_epsilon

    @torch.no_grad()
    def policy_fn(gen, obs, done, carry):
        logits, _, carry = agent(obs[None], done[None], carry)
        a_pi = categorical_sample(gen, logits[0])
        a_rand = torch.randint(0, num_actions, a_pi.shape, generator=gen, device=device)
        mix = torch.rand(a_pi.shape, generator=gen, device=device) < eps
        return torch.where(mix, a_rand, a_pi), carry

    return policy_fn, agent.initial_carry(args.collect_envs)


def _payload(state):
    opt = state.opt_state
    return {"model": state.model.state_dict(),
            "opt_state": {"count": opt.count, "mu": list(opt.mu), "nu": list(opt.nu)}}


def main(args=None):
    """Returns the evaluation results and the walls of the three stages."""
    args = args or cli(Args)
    device = device_from(args)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    run_name = f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"
    writer = MetricsWriter(run_name, args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    torch.manual_seed(args.seed)  # dropout draws from the global RNG

    env = make(args.env_id, device=device)
    policy_fn, policy_carry = None, None
    if args.policy_from:
        policy_fn, policy_carry = behavior_policy(args, env.num_actions, device)

    print(f"collecting {args.collect_steps}x{args.collect_envs} steps...")
    t0 = time.perf_counter()
    buffer = collect_trajectories(env, args.collect_steps, args.collect_envs,
                                  policy_fn=policy_fn, policy_carry=policy_carry,
                                  generator=gen)
    sync()
    collect_s = time.perf_counter() - t0
    print(f"dataset: {buffer.horizon}x{buffer.num_streams} steps, "
          f"{int(buffer.episode_starts.sum())} episodes")

    model_cfg = DTConfig(
        num_actions=env.num_actions,
        context_len=args.context_len,
        d_model=args.d_model,
        n_layers=args.n_layers,
        n_heads=args.n_heads,
        dropout=args.dropout,
        max_timestep=args.max_timestep,
        remat=args.remat,
    )
    train_cfg = DTTrainConfig(
        learning_rate=args.learning_rate,
        warmup_steps=args.warmup_steps,
        total_steps=args.total_steps,
        batch_size=args.batch_size,
    )
    state = create_dt_state(model_cfg, train_cfg, seed=args.seed, device=device,
                            state_channels=buffer.state_shape[0])
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"DT params: {n_params/1e6:.1f}M")

    g = max(1, args.steps_per_dispatch)
    train_g = make_dt_train_steps(model_cfg, args.batch_size, args.context_len, g)
    sync()
    start = time.perf_counter()
    for step in range(g, args.total_steps + 1, g):
        state, metrics = train_g(state, buffer, gen)
        if step % args.print_interval == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            tokens_sec = (step * args.batch_size * 3 * args.context_len
                          / max(time.perf_counter() - start, 1e-9))
            writer.scalars(metrics, step)
            writer.scalar("charts/tokens_per_sec", tokens_sec, step)
            print(f"step={step}/{args.total_steps} loss={metrics['dt/loss']:.4f} "
                  f"acc={metrics['dt/action_accuracy']:.3f} tokens/s={tokens_sec:.0f}")
        if args.save_interval and step % args.save_interval == 0:
            save_run(_payload(state), run_name, args.save_dir)
    sync()
    train_s = time.perf_counter() - start

    t0 = time.perf_counter()
    results = evaluate_dt(env, model_cfg, state.model, args.target_return,
                          num_envs=args.eval_envs, num_steps=args.eval_steps,
                          greedy=args.eval_greedy, rtg_clip=args.rtg_clip,
                          generator=gen, device=device)
    results = {k: float(v) for k, v in results.items()}
    eval_s = time.perf_counter() - t0
    for tag, val in results.items():
        writer.scalar(tag, val, args.total_steps)
    print(results)
    if args.save_interval:
        save_run(_payload(state), run_name, args.save_dir)
    writer.close()
    return {**results, "collect_s": collect_s, "train_s": train_s, "eval_s": eval_s,
            "episodes_collected": int(buffer.episode_starts.sum())}


if __name__ == "__main__":
    main()
