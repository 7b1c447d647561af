"""PPO on Skeleton+ (stereo-audio maze hunt), on the device simulator or
a native cartridge; twin of ``scripts/skeleton_plus_ppo.py``.

The two-tower multimodal agent (video tower on the frame, audio tower on
the two stereo MFCC planes) trains with recurrent PPO:

- ``--backend sim`` (the default): the device ``SkeletonPlusSim``
  (``envs/skeleton_plus.py``) through ``make_recurrent_ppo`` and the PPO
  runner, as ``scripts.train`` runs Minecraft2d;
- ``--backend native``: the C++ core emulates the cartridge pool of
  ``--env-id`` on the host, a ``*_native`` id (``rally_native``,
  ``brick_native``), the bare ``skeleton_plus`` the Skeleton+ ROM
  (``$MMTRL_SKELETON_ROM`` or ``roms/SkelPlus.bin``, not in the
  repository yet).  Without ``--host-loop`` the pool runs inside
  ``make_recurrent_ppo`` and the PPO runner through its
  ``reset``/``step`` (the JAX script's fused loop, which reaches the pool
  through ``io_callback``); with it, in ``algos/ppo/hostloop.py``.

Same CLI as the JAX script.  ``--capture-video`` records greedy episodes
as ``scripts.train`` does, on the fused path; the host loop ignores it,
as JAX's does.

    python -m mmtrl_tpu_torch.scripts.skeleton_plus_ppo
    python -m mmtrl_tpu_torch.scripts.skeleton_plus_ppo --cuda False --conv-size small \\
        --num-envs 2 --num-steps 8 --total-timesteps 32
    python -m mmtrl_tpu_torch.scripts.skeleton_plus_ppo --backend native --env-id rally_native
    python -m mmtrl_tpu_torch.scripts.skeleton_plus_ppo --backend native --host-loop \\
        --rom-path <SkelPlus.bin>
"""

import dataclasses

from mmtrl_tpu_torch.algos.ppo import make_recurrent_ppo
from mmtrl_tpu_torch.algos.ppo.hostloop import run_recurrent_ppo_hostloop
from mmtrl_tpu_torch.algos.ppo.runner import run_training
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs import make
from mmtrl_tpu_torch.envs.homebrew_native import make_native_env
from mmtrl_tpu_torch.models.agents import MultimodalRecurrentAgent
from mmtrl_tpu_torch.scripts._common import (
    BasePPOArgs,
    device_from,
    field,
    ppo_config_from,
    seeded,
)
from mmtrl_tpu_torch.scripts.train import recurrent_video_policy


@dataclasses.dataclass
class Args(BasePPOArgs):
    exp_name: str = field("skeleton_plus_ppo", "the name of this experiment")
    env_id: str = field("skeleton_plus", "the id of the environment")
    num_envs: int = field(8, "parallel envs")
    clip_rewards: bool = field(False, "shaped rewards stay raw")
    attn_type: str = field("casl", "crossmodal attention type")
    backend: str = field("sim", "env backend: 'sim' (device) or 'native' (real ROM)")
    rom_path: str = field("", "cartridge path for --backend native (default: the env's)")
    frameskip: int = field(8, "emulator frames per env step (native backend)")
    reward_mode: str = field("shaped", "'shaped' (sim-compatible) or 'kills' (score delta)")
    repeat_action_probability: float = field(
        0.0, "ALE-v5 sticky actions, native backend (reference envpool setting: 0.25)")
    host_loop: bool = field(
        False, "native backend via the host rollout loop (policy and update on the card, "
        "emulation on the host)")
    eval_steps: int = field(4000, "greedy eval env-steps after host-loop training (0: skip)")


def make_env(args, device):
    """``--backend sim``: the env of ``--env-id`` on the device; ``native``:
    the pool of ``--env-id`` (a ``*_native`` id; the bare sim id maps to the
    Skeleton+ ROM)."""
    if args.backend != "native":
        return make(args.env_id, device=device)
    native_key = args.env_id if args.env_id.endswith("_native") else "skeleton_plus_native"
    return make_native_env(native_key, num_envs=args.num_envs, rom_path=args.rom_path,
                           seed=args.seed, frameskip=args.frameskip,
                           reward_mode=args.reward_mode,
                           repeat_action_probability=args.repeat_action_probability,
                           device=device)


def main(args=None):
    args = args or cli(Args)
    if args.host_loop and args.backend != "native":
        raise SystemExit("--host-loop requires --backend native")
    device = device_from(args)
    env = make_env(args, device)
    try:
        cfg = ppo_config_from(args)
        model = seeded(args.seed, device, lambda: MultimodalRecurrentAgent(
            num_actions=env.num_actions,
            conv_type=args.conv_size,
            attn_type=args.attn_type,
            fusion_type=args.fusion_type,
            input_scale=1.0,  # the observations lie in [-1, 1]: no legacy /255
            audio_channels=env.observation_space.shape[0] - 1,
            device=device,
        ))
        if not args.host_loop:
            video_setup = (env, recurrent_video_policy, lambda rs: rs.model,
                           model.initial_carry(getattr(env, "num_envs", 1))
                           ) if args.capture_video else None
            return run_training(make_recurrent_ppo(env, model, cfg), cfg, args, device,
                                video_setup=video_setup)
        return run_recurrent_ppo_hostloop(env, model, cfg, args, device,
                                          eval_steps=args.eval_steps)
    finally:
        if args.backend == "native":
            env.close()


if __name__ == "__main__":
    main()
