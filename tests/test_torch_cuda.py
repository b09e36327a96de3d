"""The CUDA kernel on the card, against its plain PyTorch version.

These tests need an NVIDIA GPU with nvcc (they build ops/csrc/gf_matmul.cu);
elsewhere they skip. On the GPU machine run them with
`python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda`
(tests/conftest.py imports jax, which the port's machine need not have;
this file needs none of its fixtures).
"""

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch.ops import bitmatrix, cuda_gf, gf256, rs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("r,n,lead,k", [
    (4, 12, (3,), 4096), (3, 6, (), 1000), (22, 16, (2, 2), 12345),
    (30, 30, (3,), 777), (0, 6, (2,), 256), (40, 50, (1,), 300),
    (2, 1600, (1,), 64),
])
def test_kernel_equals_plain_on_card(dev, r, n, lead, k):
    rng = np.random.default_rng(r * 1000 + n)
    coef = rng.integers(0, 256, (r, n), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    x = torch.from_numpy(rng.integers(0, 256, (*lead, n, k), dtype=np.uint8)).to(dev)
    before = cuda_gf.LAUNCHES
    got = cuda_gf.gf_matmul(bits, x)
    want = rs.gf_matmul_bytes(bits, x)
    torch.cuda.synchronize()
    assert got.shape == (*lead, r, k)
    assert torch.equal(got, want)
    assert cuda_gf.LAUNCHES - before == (len(cuda_gf.blocks(r, n)) if r else 0)
    if r:
        host = x.reshape(-1, n, k)[0].cpu().numpy()
        assert np.array_equal(got.reshape(-1, r, k)[0].cpu().numpy(),
                              gf256.gf_matmul(coef, host))


def test_kernel_rejects_non_contiguous(dev):
    bits = rs.get_kernel(4, 2, dev).parity_bits
    x = torch.zeros((4, 64), dtype=torch.uint8, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        cuda_gf.gf_matmul(bits, x)
