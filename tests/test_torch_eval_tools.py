"""The port's evaluation tools (``mmtrl_tpu_torch/tools/``) against the JAX
repo's ``tools/eval_pong.py`` and ``tools/eval_rom_policy.py`` on the CPU,
from one tiny JAX checkpoint (the small-tower casl agent, input scale 1,
random weights) and the same weights converted:

- ``eval_pong`` greedy against ``noop``, ``tracker`` and ``self``: the
  same points for and against, differential, win rate and episode count
  (both tools' greedy lines equal);
- ``eval_rom_policy`` greedy on ``rally_native``: the same return, length
  and episode count;
- both tools default to the card and raise without one.

The sampled halves draw from other generators (torch's, JAX's keys), so
only their completion is checked."""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from mmtrl_tpu.core.checkpoint import save_run as jax_save_run
from mmtrl_tpu.models.agents import MultimodalRecurrentAgent as JaxAgent
from mmtrl_tpu_torch.convert import agent_params_from_flax
from mmtrl_tpu_torch.core.checkpoint import save_run
from mmtrl_tpu_torch.tools import eval_pong, eval_rom_policy

REPO = Path(__file__).resolve().parent.parent
# 2 joint envs (4 slots), 120 steps, episodes capped at 50 steps: 4
# episodes a rule
PONG_ARGV = ["--num-envs", "2", "--num-steps", "120", "--episode-steps", "50"]
# 2 RALLY envs for 160 steps: a greedy episode ends in some 100-160
ROM_ARGV = ["--env-id", "rally_native", "--num-envs", "2", "--num-steps", "160"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(JAX checkpoint, port checkpoint) of one random agent: 6 actions,
    small towers, casl, sum fusion, input scale 1, two audio channels."""
    tmp = tmp_path_factory.mktemp("tools")
    model = JaxAgent(num_actions=6, conv_type="small", attn_type="casl", fusion_type="sum",
                     input_scale=1.0)
    params = jax.jit(model.init)(jax.random.PRNGKey(4), jnp.zeros((1, 2, 3, 84, 84)),
                                 jnp.zeros((1, 2), bool), model.initial_carry(2))
    jax_ckpt = jax_save_run({"train_state": {"params": params}}, "jax_agent", str(tmp))
    port_ckpt = save_run({"model": agent_params_from_flax(jax.device_get(params))}, "port_agent",
                         str(tmp))
    return jax_ckpt, port_ckpt


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_tool_{name}",
                                                  REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(capsys, prefix):
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith(prefix)]


@pytest.mark.parametrize("opponent", ["noop", "tracker", "self"])
def test_eval_pong_matches_the_jax_tool(opponent, checkpoints, capsys, monkeypatch):
    """The greedy line of each tool, character for character: points for
    and against, differential, win rate and episodes."""
    jax_ckpt, port_ckpt = checkpoints
    monkeypatch.setattr(sys, "argv", ["eval_pong.py", "--load-from", jax_ckpt,
                                      "--opponent", opponent] + PONG_ARGV)
    _jax_tool("eval_pong").main()
    want = _lines(capsys, "greedy")
    out = eval_pong.main(["--cuda", "False", "--load-from", port_ckpt,
                          "--opponent", opponent] + PONG_ARGV)
    got = _lines(capsys, "greedy")
    assert got == want and got[0].startswith(f"greedy vs {opponent}: diff=")
    assert out["greedy"]["episodes"] == 4 and out["sampled"]["episodes"] == 4


def test_eval_rom_policy_matches_the_jax_tool(checkpoints, capsys, monkeypatch):
    jax_ckpt, port_ckpt = checkpoints
    monkeypatch.setattr(sys, "argv", ["eval_rom_policy.py", "--load-from", jax_ckpt] + ROM_ARGV)
    _jax_tool("eval_rom_policy").main()
    want = _lines(capsys, "greedy")
    out = eval_rom_policy.main(["--cuda", "False", "--load-from", port_ckpt] + ROM_ARGV)
    got = _lines(capsys, "greedy")
    assert got == want and len(got) == 1
    assert out["greedy"]["eval/episodes"] >= 1
    assert set(out) == {"greedy", "sampled"}


@pytest.mark.parametrize("tool", [eval_pong, eval_rom_policy])
def test_tools_default_to_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--load-from", "missing"])
