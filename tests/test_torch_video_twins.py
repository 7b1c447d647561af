"""The four entry points whose JAX twins pass a ``video_setup`` (``train``,
``ppo``, ``ppo_continuous_action``, ``skeleton_plus_ppo``) write, with
``--capture-video``, the GIF that JAX's write.  Each script runs through
``main`` with no update (a budget under one rollout), so its final GIF
records the initial agent: JAX's run as it is (its runner's init jitted),
the port's with JAX's weights loaded into the agent and the env's sampler
hooks replaying the draws of JAX's key chain (``seed + 777``) at the
capture.  The GIFs decode (PIL) to the same frames, delays and loop;
on Minecraft2d within one grey level, as its render bank is within 1e-5
of JAX's in observation units (ROADMAP C.5), and on the classic envs, whose
float32 ``sin``/``cos`` are an ulp from XLA's (C.17): either can move a
pixel across a level's edge.  This file runs ``train`` and
``ppo_continuous_action``; ``test_torch_video_twins_more.py`` the other
two."""

import numpy as np
import pytest
import torch

import jax
from mmtrl_tpu.core.config import cli as jax_cli
from mmtrl_tpu.utils import video as jax_video
from mmtrl_tpu_torch.algos.ppo import runner as port_runner
from mmtrl_tpu_torch.convert import agent_params_from_flax
from mmtrl_tpu_torch.core.config import cli
from mmtrl_tpu_torch.envs.classic._base import ClassicEnv
from mmtrl_tpu_torch.envs.classic.pendulum import Pendulum
from mmtrl_tpu_torch.envs.minecraft2d import Minecraft2d
from mmtrl_tpu_torch.envs.skeleton_plus import SkeletonPlusSim
from mmtrl_tpu_torch.scripts import ppo, ppo_continuous_action, skeleton_plus_ppo, train
from test_torch_classic import Replay as ClassicReplay
from test_torch_classic import reset_values
from test_torch_continuous import reset_values as pendulum_reset_values
from test_torch_envs import Replay as MinecraftReplay
from test_torch_scripts import _jax_script
from test_torch_skeleton_plus import Replay as SkeletonReplay
from test_torch_video import _episode_keys, _second_halves, assert_same_gif

SCRIPTS = {"train": train, "ppo": ppo, "ppo_continuous_action": ppo_continuous_action,
           "skeleton_plus_ppo": skeleton_plus_ppo}
LEVELS = {"train": 1, "ppo": 1, "ppo_continuous_action": 1, "skeleton_plus_ppo": 0}
ARGV = {"train": ["--conv-size", "small", "--attn-type", "casl"], "ppo": [],
        "ppo_continuous_action": [], "skeleton_plus_ppo": ["--conv-size", "small"]}


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


def _innermost(env):
    while hasattr(env, "env"):
        env = env.env
    return env


def _replay_jax_draws(env, jenv, key, steps=256):
    """Sets the port env's sampler hooks to the draws JAX's
    ``record_episode`` makes from ``key`` (one env)."""
    env, jenv = _innermost(env), _innermost(jenv)
    reset_keys, step_keys = _episode_keys(key, 1, steps)
    keys = jax.numpy.stack([reset_keys] + [_second_halves(k) for k in step_keys])
    states = jax.jit(jax.vmap(jax.vmap(lambda k: jenv._reset(k)[1])))(keys)
    per_reset = [jax.tree_util.tree_map(lambda x, i=i: np.asarray(x[i]), states)
                 for i in range(keys.shape[0])]
    if isinstance(env, Minecraft2d):
        env.sampler = MinecraftReplay([(
            torch.tensor(np.stack([s.agent[:, 0] * 5 + s.agent[:, 1], s.good[:, 0] * 5 + s.good[:, 1],
                                   s.bad[:, 0] * 5 + s.bad[:, 1], s.gem[:, 0] * 5 + s.gem[:, 1]],
                                  axis=1)).long(),
            torch.tensor(s.gem_type).long()) for s in per_reset])
    elif isinstance(env, ClassicEnv):
        values = pendulum_reset_values if isinstance(env, Pendulum) else reset_values
        env.sampler = ClassicReplay([values(s) for s in per_reset])
    elif isinstance(env, SkeletonPlusSim):
        replay = SkeletonReplay()
        replay.attach(env)
        replay.push_reset(reset_keys)
        for keys in step_keys:
            replay.push_step(keys)
    else:
        raise TypeError(type(env).__name__)


def check_twin(name, in_tmp, monkeypatch):
    """Runs JAX's script ``name`` and the port's twin, and compares their
    final GIFs."""
    argv = ARGV[name] + ["--capture-video", "--total-timesteps", "1"]
    jax_script = _jax_script(name)
    captured = {}
    real_capture = jax_video.capture_video

    def jax_capture(env, step_policy, params, run_name, key, **kw):
        captured.update(env=env, params=jax.device_get(params), key=key)
        return real_capture(env, step_policy, params, run_name, key, **kw)

    monkeypatch.setattr(jax_video, "capture_video", jax_capture)
    real_training = jax_script.run_training
    monkeypatch.setattr(jax_script, "run_training", lambda init_runner, *a, **kw: real_training(
        jax.jit(init_runner), *a, **kw))
    (in_tmp / "jax").mkdir()
    monkeypatch.chdir(in_tmp / "jax")
    jax_script.main(jax_cli(jax_script.Args, argv))

    real_port_capture = port_runner.capture_video

    def port_capture(env, step_policy, model, run_name, generator, **kw):
        model.load_state_dict(agent_params_from_flax(captured["params"]))
        _replay_jax_draws(env, captured["env"], captured["key"])
        return real_port_capture(env, step_policy, model, run_name, generator, **kw)

    monkeypatch.setattr(port_runner, "capture_video", port_capture)
    (in_tmp / "port").mkdir()
    monkeypatch.chdir(in_tmp / "port")
    out = SCRIPTS[name].main(cli(SCRIPTS[name].Args, ["--cuda", "False"] + argv))
    assert out["videos"] == [f"videos/{out['run_name']}/final.gif"]
    (ref,) = (in_tmp / "jax" / "videos").glob("*/final.gif")
    assert ref.parent.name.split("__")[:3] == out["run_name"].split("__")[:3]
    assert_same_gif(out["videos"][0], str(ref), levels=LEVELS[name])


@pytest.mark.parametrize("name", ["train", "ppo_continuous_action"])
def test_video_setup_writes_the_gif_jax_writes(name, in_tmp, monkeypatch):
    check_twin(name, in_tmp, monkeypatch)
