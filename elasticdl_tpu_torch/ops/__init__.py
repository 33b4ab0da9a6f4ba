"""The port's hand kernels: each module holds a kernel's wrapper, its
plain version and the `torch.library` custom op around them."""

# the modules that register the kernels' custom ops (`elasticdl_torch::
# ...`): a process that loads a torch export imports them
KERNEL_OP_MODULES = ("elasticdl_tpu_torch.ops.flash_attention",
                     "elasticdl_tpu_torch.ops.scatter_add")
