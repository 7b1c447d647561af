"""``--capture-video`` of ``skeleton_plus_ppo`` (the device simulator) and
``ppo`` (CartPole) against their JAX twins, as
``test_torch_video_twins.py`` checks ``train`` and
``ppo_continuous_action`` (the two files keep each under about 40 s)."""

import pytest
import torch

from test_torch_video_twins import check_twin


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MMTRL_RUN_ROOT", str(tmp_path / "runs"))
    monkeypatch.setenv("MMTRL_NO_COMPILE_CACHE", "1")  # the JAX cli's own cache
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield tmp_path
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["skeleton_plus_ppo", "ppo"])
def test_video_setup_writes_the_gif_jax_writes(name, in_tmp, monkeypatch):
    check_twin(name, in_tmp, monkeypatch)
