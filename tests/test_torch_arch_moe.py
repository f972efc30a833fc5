"""One train step of the MoE archs (arctic-480b: dense residual, top-2 of
4 experts at reduced size; llama4-scout: shared expert, chunked and global
attention) in the port against the reference's `make_setup` step on the
CPU, the load-balance aux loss in the total loss included (the helpers
are tests/test_torch_arch_train.py's)."""
import pytest
import torch

from test_torch_arch_train import PARITY, step_parity


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("aid", PARITY["test_torch_arch_moe"])
def test_train_step_matches_reference(aid):
    _, _, m = step_parity(aid)
    assert float(m["total_loss"]) > float(m["loss"])   # the aux loss counts
