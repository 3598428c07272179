"""kubebrain on PyTorch and CUDA: the etcd3 MVCC store whose range scans run
as hand-written CUDA kernels over a sorted block mirror held on the GPU.

The layout follows ``kubebrain_tpu`` module by module, so each counterpart
is found at the same path. The package imports ``torch`` and numpy only.
Entry points take ``device=None``, which means ``"cuda"``; without a card
they raise (:func:`kubebrain_tpu_torch.device.resolve_device`). The CPU is
used only when the caller asks for it, as the tests do.
"""

__all__ = ["device"]
