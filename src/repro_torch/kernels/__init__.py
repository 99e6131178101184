"""Hand-written Hopper kernels, their plain PyTorch versions, and the
router that picks between them by the device of the tensors."""
