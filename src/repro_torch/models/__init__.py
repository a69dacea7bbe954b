"""The LM model zoo: config, layers, GQA attention (plain under autograd
for training, the ``flash_attention`` kernel at prefill), the superblock
stack and the model API (``init_params``, ``loss_fn``, ``prefill``,
``serve_step``)."""
