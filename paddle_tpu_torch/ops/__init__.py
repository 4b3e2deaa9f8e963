"""Fused operators: the hand-written CUDA kernels, their wrappers and their
plain PyTorch versions."""

_COUNTERS = ("launches", "step_launches", "widen_casts")


def _wrappers() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from paddle_tpu_torch.kernels.opt_update import adam, momentum
    from paddle_tpu_torch.kernels.rnn_cells import (gru_cell, gru_cell_infer,
                                                    lstm_cell,
                                                    lstm_cell_infer)
    from paddle_tpu_torch.ops.attention import flash_bwd, flash_fwd
    from paddle_tpu_torch.ops.crf import crf_alpha_fwd, crf_bwd, crf_viterbi
    from paddle_tpu_torch.ops.ctc import (ctc_alpha_fwd, ctc_bwd,
                                          ctc_fused_bwd, ctc_fused_fwd)
    from paddle_tpu_torch.ops.gru import gru_bwd_chain, gru_bwd_step, \
        gru_seq, gru_seq_train
    from paddle_tpu_torch.ops.lstm import lstm_bwd_chain, lstm_bwd_step, \
        lstm_seq, lstm_seq_train
    return {"lstm_seq": lstm_seq, "lstm_seq_train": lstm_seq_train,
            "lstm_bwd_chain": lstm_bwd_chain,
            "lstm_bwd_step": lstm_bwd_step, "gru_seq": gru_seq,
            "gru_seq_train": gru_seq_train, "gru_bwd_chain": gru_bwd_chain,
            "gru_bwd_step": gru_bwd_step,
            "gru_cell": gru_cell, "gru_cell_infer": gru_cell_infer,
            "lstm_cell": lstm_cell, "lstm_cell_infer": lstm_cell_infer,
            "crf_alpha_fwd": crf_alpha_fwd,
            "crf_bwd": crf_bwd, "crf_viterbi": crf_viterbi,
            "ctc_alpha_fwd": ctc_alpha_fwd, "ctc_bwd": ctc_bwd,
            "ctc_fused_fwd": ctc_fused_fwd, "ctc_fused_bwd": ctc_fused_bwd,
            "flash_fwd": flash_fwd, "flash_bwd": flash_bwd,
            "momentum": momentum, "adam": adam}


def kernel_counts() -> dict:
    """{kernel: {counter: n}} of this process: the launches each kernel
    wrapper counted (``/healthz`` and ``--job train`` report them, so a run
    can show that its main path went through the kernels). A wrapper with
    a bfloat16 form (the LSTM and GRU sequence kernels) counts that form's
    launches apart, reported as ``<kernel>_bf16``."""
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = {k: getattr(fn, k) for k in _COUNTERS
                        if hasattr(fn, k)}
        if hasattr(fn, "bf16_launches"):
            counts[name + "_bf16"] = {"launches": fn.bf16_launches}
    return counts


def reset_kernel_counts():
    """Set every kernel wrapper's counters to 0."""
    for fn in _wrappers().values():
        for k in _COUNTERS + ("bf16_launches",):
            if hasattr(fn, k):
                setattr(fn, k, 0)
