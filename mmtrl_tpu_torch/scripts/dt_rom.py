"""Offline decision transformer on the native 2600 cartridges; twin of
``scripts/dt_rom.py``.

Three stages, each through the host loop (``algos/dt/hostloop.py``):

  1. collect: the C++ pool steps the cartridge; a behaviour policy acts on
     the card with epsilon-random actions: a PPO agent saved by
     ``scripts.rally_ppo``/``brick_ppo``/``skeleton_plus_ppo``
     (``--policy-kind ppo``), a Q network saved by ``scripts.dqn_rom``
     (argmax-Q, ``dqn``) or ``scripts.c51_rom`` (argmax of the expected Q
     over the support, ``c51``), or uniform actions without
     ``--policy-from``;
  2. train: the offline DT (``make_dt_train_steps``), attention through the
     CUDA kernels, optionally with MoE FFNs (``--moe-experts``);
  3. eval: return-conditioned on the same cartridge.

Same CLI as the JAX script.

    python -m mmtrl_tpu_torch.scripts.dt_rom --env-id rally_native \\
        --policy-from saved_agents/<run> --policy-conv-size big \\
        --moe-experts 4 --moe-top-k 2 --moe-dispatch gather
    python -m mmtrl_tpu_torch.scripts.dt_rom --env-id rally_native \\
        --policy-from saved_agents/<dqn_rom run> --policy-kind dqn
"""

import dataclasses
import time
from typing import Optional

import torch

from mmtrl_tpu_torch.algos.dt import DTTrainConfig, create_dt_state, make_dt_train_steps
from mmtrl_tpu_torch.algos.dt.hostloop import collect_trajectories_host, evaluate_dt_host
from mmtrl_tpu_torch.algos.offpolicy import expected_q_greedy
from mmtrl_tpu_torch.algos.offpolicy.hostloop_dqn import argmax_q
from mmtrl_tpu_torch.core.checkpoint import load_run, save_run
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.core.metrics import MetricsWriter
from mmtrl_tpu_torch.envs.homebrew_native import make_native_env
from mmtrl_tpu_torch.models.agents import (
    DistributionalQNetwork,
    MultimodalRecurrentAgent,
    QNetwork,
)
from mmtrl_tpu_torch.models.decision_transformer import DTConfig
from mmtrl_tpu_torch.models.distributions import categorical_sample
from mmtrl_tpu_torch.scripts._common import device_from, field
from mmtrl_tpu_torch.scripts.dt_minecraft import _payload


@dataclasses.dataclass
class Args:
    exp_name: str = field("dt_rom", "the name of this experiment")
    seed: int = field(1, "seed of the experiment")
    torch_deterministic: bool = field(
        True, "set torch.backends.cudnn.deterministic (deterministic cuDNN algorithms)")
    cuda: bool = field(True, "run on the CUDA card (raises without one); False: on the CPU")
    track: bool = field(False, "CLI compat")
    capture_video: bool = field(False, "CLI compat")
    env_id: str = field("skeleton_plus_native", "skeleton_plus_native | rally_native | brick_native")
    rom_path: str = field("", "cartridge path (default: per env-id)")
    frameskip: int = field(8, "emulator frames per env step")
    episode_steps: int = field(1500, "env-step cap per episode")
    reward_mode: str = field("shaped", "'shaped'/'kills' (skeleton), 'score'/'win' (rally)")
    repeat_action_probability: float = field(
        0.0, "ALE-v5 sticky actions (reference envpool setting: 0.25)")
    # --- behavior policy (stage 1) ---
    policy_from: str = field("", "checkpoint of a PPO, DQN or C51 host-loop run "
                             "(saved_agents/<run>); empty = random")
    policy_kind: str = field("ppo", "behavior checkpoint kind: ppo (recurrent actor) | dqn | c51 "
                             "(hostloop_dqn train states)")
    policy_epsilon: float = field(0.1, "random-action mixture for dataset diversity")
    policy_greedy: bool = field(False, "argmax instead of sampling from the policy")
    policy_attn_type: str = field("casl", "ppo behavior agent attention type")
    policy_conv_size: str = field("small", "ppo behavior agent conv tower size")
    policy_fusion_type: str = field("sum", "ppo behavior agent fusion type")
    policy_n_atoms: int = field(51, "c51 behavior: categorical support atoms (must match training)")
    policy_v_min: float = field(-10.0, "c51 behavior: support lower bound")
    policy_v_max: float = field(10.0, "c51 behavior: support upper bound")
    collect_envs: int = field(16, "parallel emulated cartridges for collection")
    collect_steps: int = field(65536, "total env transitions to collect")
    # --- DT (stage 2) ---
    context_len: int = field(30, "context window K (3K tokens)")
    d_model: int = field(512, "transformer width")
    n_layers: int = field(6, "transformer depth")
    n_heads: int = field(4, "attention heads")
    dropout: float = field(0.1, "dropout rate")
    max_timestep: int = field(2048, "timestep embedding table size (> episode cap)")
    remat: bool = field(False, "rematerialize block activations")
    moe_experts: int = field(0, "MoE FFN experts per block (0: dense FFN)")
    moe_top_k: int = field(2, "MoE router top-k")
    moe_dispatch: str = field(
        "dense", "MoE token dispatch: 'dense' (GShard einsum) or 'gather' "
        "(capacity-based top-k, models/moe.py)")
    learning_rate: float = field(6e-4, "peak LR")
    warmup_steps: int = field(512, "LR warmup steps")
    total_steps: int = field(15000, "offline training steps")
    batch_size: int = field(64, "training batch size")
    steps_per_dispatch: int = field(30, "train steps per make_dt_train_steps call")
    print_interval: int = field(600, "print every n training steps")
    # --- eval (stage 3) ---
    eval_steps: int = field(6000, "return-conditioned eval env-steps (pool steps x envs)")
    target_return: float = field(150.0, "return target for conditioning")
    rtg_clip: Optional[float] = field(None, "clip the running target to the data support")
    eval_greedy: bool = field(True, "greedy action selection in eval")
    save_interval: int = field(0, "save train state every n steps (0: never)")
    save_dir: str = field("saved_agents", "checkpoint folder")


def q_behavior_policy(args, env, device):
    """(policy_fn, None) of the Q network saved at ``--policy-from`` by
    ``scripts.dqn_rom`` or ``scripts.c51_rom``: its greedy action (argmax-Q;
    C51: of the expected Q over the support) mixed with epsilon-random
    actions, the policy the Q run itself evaluates greedily."""
    kw = dict(num_actions=env.num_actions, input_scale=1.0,
              obs_shape=env.observation_space.shape, device=device)
    if args.policy_kind == "dqn":
        qnet, greedy_fn = QNetwork(**kw), argmax_q
    else:
        qnet = DistributionalQNetwork(n_atoms=args.policy_n_atoms, **kw)
        greedy_fn = expected_q_greedy(torch.linspace(
            args.policy_v_min, args.policy_v_max, args.policy_n_atoms, device=device))
    qnet.load_state_dict(load_run(args.policy_from, map_location=device)["model"])
    eps, n_act = args.policy_epsilon, env.num_actions

    @torch.no_grad()
    def policy_fn(gen, obs, done, carry):
        pi = greedy_fn(qnet, obs)
        rand = torch.randint(0, n_act, pi.shape, generator=gen, device=device)
        mix = torch.rand(pi.shape, generator=gen, device=device) < eps
        return torch.where(mix, rand, pi), carry

    return policy_fn, None


def behavior_policy(args, env, device):
    """(policy_fn, initial carry) of the agent saved at ``--policy-from``
    with epsilon-random actions, or (None, None)."""
    if not args.policy_from:
        return None, None
    if args.policy_kind in ("dqn", "c51"):
        return q_behavior_policy(args, env, device)
    agent = MultimodalRecurrentAgent(
        num_actions=env.num_actions,
        conv_type=args.policy_conv_size,
        attn_type=args.policy_attn_type or None,
        fusion_type=args.policy_fusion_type,
        input_scale=1.0,
        audio_channels=env.observation_space.shape[0] - 1,
        device=device,
    )
    agent.load_state_dict(load_run(args.policy_from, map_location=device)["model"])
    eps, n_act = args.policy_epsilon, env.num_actions

    @torch.no_grad()
    def policy_fn(gen, obs, done, carry):
        logits, _, carry = agent(obs[None], done[None], carry)
        pi = logits[0].argmax(dim=-1) if args.policy_greedy else categorical_sample(gen, logits[0])
        rand = torch.randint(0, n_act, pi.shape, generator=gen, device=device)
        mix = torch.rand(pi.shape, generator=gen, device=device) < eps
        return torch.where(mix, rand, pi), carry

    return policy_fn, agent.initial_carry(env.num_envs, device)


def main(args=None):
    """Returns the behaviour and evaluation statistics, the last training
    metrics and the walls of the three stages."""
    args = args or cli(Args)
    if args.episode_steps > args.max_timestep:
        # timesteps past the embedding table have no row of their own
        raise SystemExit(
            f"--episode-steps {args.episode_steps} exceeds --max-timestep "
            f"{args.max_timestep}; raise the embedding table to at least the episode cap")
    device = device_from(args)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    run_name = f"{args.env_id}__{args.exp_name}__{args.seed}__{int(time.time())}"
    writer = MetricsWriter(run_name, args)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    torch.manual_seed(args.seed)  # dropout draws from the global RNG

    env = make_native_env(args.env_id, num_envs=args.collect_envs, rom_path=args.rom_path,
                          seed=args.seed, frameskip=args.frameskip,
                          episode_steps=args.episode_steps, reward_mode=args.reward_mode,
                          repeat_action_probability=args.repeat_action_probability,
                          device=device)
    try:
        policy_fn, carry = behavior_policy(args, env, device)
        pool_steps = max(1, args.collect_steps // args.collect_envs)
        t0 = time.perf_counter()
        buffer, bstats = collect_trajectories_host(env, gen, pool_steps, policy_fn, carry,
                                                   print_every=max(1, pool_steps // 10))
        sync()
        collect_s = time.perf_counter() - t0
        print(f"collected {pool_steps * args.collect_envs} transitions in {collect_s:.1f}s; "
              f"behavior return {bstats['behavior/episodic_return']:.2f} over "
              f"{int(bstats['behavior/episodes'])} episodes", flush=True)
        for tag, val in bstats.items():
            writer.scalar(tag, val, 0)

        model_cfg = DTConfig(
            num_actions=env.num_actions,
            context_len=args.context_len,
            d_model=args.d_model,
            n_layers=args.n_layers,
            n_heads=args.n_heads,
            dropout=args.dropout,
            max_timestep=args.max_timestep,
            remat=args.remat,
            moe_experts=args.moe_experts,
            moe_top_k=args.moe_top_k,
            moe_dispatch=args.moe_dispatch,
        )
        train_cfg = DTTrainConfig(learning_rate=args.learning_rate,
                                  warmup_steps=args.warmup_steps,
                                  total_steps=args.total_steps, batch_size=args.batch_size)
        state = create_dt_state(model_cfg, train_cfg, seed=args.seed, device=device,
                                state_channels=buffer.state_shape[0])
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"DT params: {n_params/1e6:.1f}M", flush=True)

        g = max(1, args.steps_per_dispatch)
        train_g = make_dt_train_steps(model_cfg, args.batch_size, args.context_len, g)
        metrics = {}
        sync()
        start = time.perf_counter()
        for step in range(g, args.total_steps + 1, g):
            state, metrics = train_g(state, buffer, gen)
            if step % args.print_interval < g:
                metrics = {k: float(v) for k, v in metrics.items()}
                tokens_sec = (step * args.batch_size * 3 * args.context_len
                              / max(time.perf_counter() - start, 1e-9))
                writer.scalars(dict(sorted(metrics.items())), step)  # JAX's device_get order
                print(f"step={step}/{args.total_steps} loss={metrics['dt/loss']:.4f} "
                      f"acc={metrics['dt/action_accuracy']:.3f} tokens/s={tokens_sec:.0f}",
                      flush=True)
            if args.save_interval and step % args.save_interval < g:
                save_run(_payload(state), run_name, args.save_dir)
        sync()
        train_s = time.perf_counter() - start
        steps_trained = (args.total_steps // g) * g

        # A surviving policy ends episodes only at the time cap, so the
        # evaluation runs at least one episode's length.
        eval_pool_steps = max(args.episode_steps + 100, args.eval_steps // args.collect_envs)
        t0 = time.perf_counter()
        results = evaluate_dt_host(env, model_cfg, state.model, gen, args.target_return,
                                   num_steps=eval_pool_steps, greedy=args.eval_greedy,
                                   rtg_clip=args.rtg_clip)
        sync()
        eval_s = time.perf_counter() - t0
        for tag, val in results.items():
            writer.scalar(tag, float(val), args.total_steps)
        print("final return-conditioned eval: "
              + " ".join(f"{k}={float(v):.2f}" for k, v in results.items()), flush=True)
        if args.save_interval:
            save_run(_payload(state), run_name, args.save_dir)
        writer.close()
        return {**bstats, **results, **{k: float(v) for k, v in metrics.items()},
                "collect_s": collect_s, "train_s": train_s, "eval_s": eval_s,
                "train_steps": steps_trained, "eval_pool_steps": eval_pool_steps,
                "tokens_per_s": steps_trained * args.batch_size * 3 * args.context_len
                / max(train_s, 1e-9)}
    finally:
        env.close()


if __name__ == "__main__":
    main()
