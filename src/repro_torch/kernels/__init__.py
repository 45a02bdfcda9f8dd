"""Hand-written Hopper kernels (CUDA sources in ../csrc), their plain
PyTorch versions, and the dispatch entry points (`ops`)."""


def refuse_grad(name: str, *tensors) -> None:
    """Raise when grad mode is on and any of `tensors` requires grad.  K1,
    K2, K3 and K5 have no backward: their CUDA outputs are filled through
    raw pointers and would silently carry no gradient, so they refuse such
    inputs on every device (serving runs without gradients)."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            "inputs that do not require grad (only K4, "
            "striped_flash_attention, is differentiable)")
