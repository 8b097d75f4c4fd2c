"""Multi-GPU counting over torch.distributed (counterpart of
meryl_tpu/parallel/).

One process and one device a rank: NCCL when the device is cuda, gloo
only when the caller asks for device=cpu.  Submodules are imported
lazily, as in the reference, so that `import meryl_tpu_torch.parallel`
touches neither torch.distributed nor a device.
"""
