"""C51 on a real 2600 cartridge, the reference's c51_atari leg; twin of
``scripts/c51_rom.py``.

The categorical DQN (a per-action distribution over a fixed support of
51 atoms on [-10, 10]; cleanrl/c51_atari_jax.py) trains through the DQN
host loop (``algos/offpolicy/hostloop_dqn.py``) with C51's two hooks:
acting greedily on the expected Q, sum_i p_i(s, a) z_i, and
``c51_td_update`` (projection and cross-entropy).  Adam's eps is
c51_jax's 0.01 / batch_size.  Same CLI and defaults as the JAX script.

Cadence against the reference's c51_atari defaults (train_frequency 4,
batch 32; a target sync every 10,000 env steps): 8 pool envs,
``--train-frequency 2`` at batch 128 and ``--target-network-frequency
1250`` pool steps keep both ratios.

    python -m mmtrl_tpu_torch.scripts.c51_rom
"""

import dataclasses

import torch

from mmtrl_tpu_torch.algos.offpolicy import c51_td_update, expected_q_greedy
from mmtrl_tpu_torch.algos.offpolicy.hostloop_dqn import run_dqn_hostloop
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.models.agents import DistributionalQNetwork
from mmtrl_tpu_torch.scripts import dqn_rom
from mmtrl_tpu_torch.scripts._common import field, seeded


@dataclasses.dataclass
class Args(dqn_rom.Args):
    exp_name: str = field("c51_rom", "the name of this experiment")
    learning_rate: float = field(2.5e-4, "Adam lr (c51_atari default)")
    target_network_frequency: int = field(1250, "target sync every n POOL steps")
    n_atoms: int = field(51, "support atoms (c51_atari default)")
    v_min: float = field(-10.0, "support lower bound")
    v_max: float = field(10.0, "support upper bound")


def main(args=None):
    args = args or cli(Args)
    device, env, cfg = dqn_rom.setup(args)
    try:
        model = seeded(args.seed, device, lambda: DistributionalQNetwork(
            num_actions=env.num_actions, n_atoms=args.n_atoms, input_scale=1.0,
            obs_shape=env.observation_space.shape, device=device))
        atoms = torch.linspace(args.v_min, args.v_max, args.n_atoms, device=device)

        def update_fn(ts, batch):
            return c51_td_update(atoms, cfg.gamma, ts, batch)

        return run_dqn_hostloop(env, model, cfg, args, device, eval_steps=args.eval_steps,
                                greedy_fn=expected_q_greedy(atoms), update_fn=update_fn,
                                adam_eps=0.01 / args.batch_size)
    finally:
        env.close()


if __name__ == "__main__":
    main()
