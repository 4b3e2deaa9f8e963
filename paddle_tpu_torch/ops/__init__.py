"""Fused operators: the hand-written CUDA kernels, their wrappers and their
plain PyTorch versions."""


def kernel_counts() -> dict:
    """{kernel: {counter: n}} of this process: the launches each kernel
    wrapper counted (``/healthz`` reports them, so a run can show that
    its main path went through the kernels)."""
    from paddle_tpu_torch.ops.lstm import lstm_seq
    return {"lstm_seq": {"launches": lstm_seq.launches,
                         "step_launches": lstm_seq.step_launches}}
