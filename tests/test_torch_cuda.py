"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``cuda`` and skips where there is no
NVIDIA GPU: a CUDA kernel has no CPU mode. The file imports neither JAX
nor the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py -q

Tolerance rtol 1e-4 / atol 1e-5: the kernel sums h @ W in another order
than cuBLAS, over K=H and T steps of recurrence.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import lstm as tlstm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    mask = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    return (f(T, B, 4 * H), mask, f(H, 4 * H, scale=H ** -0.5),
            f(H, scale=0.1), f(H, scale=0.1), f(H, scale=0.1),
            f(B, H, scale=0.5), f(B, H, scale=0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(20, 5, 40), (20, 64, 256), (3, 33, 96)])
def test_lstm_kernel_matches_plain_on_card(cuda_device, T, B, H):
    """Ragged batches, and widths that do not fill a 32 x 32 tile."""
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(T, B, H, seed=B + H)]
    before = tlstm.lstm_seq.launches
    got = tlstm.lstm_seq(*ins)
    torch.cuda.synchronize()
    assert tlstm.lstm_seq.launches == before + 1
    want = tlstm.lstm_sequence_plain(*ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_lstm_kernel_rejects_bad_inputs(cuda_device):
    ins = [torch.from_numpy(a).to(cuda_device)
           for a in _inputs(4, 2, 8, seed=0)]
    with pytest.raises(ValueError, match="float32"):
        tlstm.lstm_seq(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError, match="shape"):
        tlstm.lstm_seq(ins[0], ins[1][:, :1].contiguous(), *ins[2:])
