"""The LM model zoo's serving path: config, layers, GQA attention with the
``flash_attention`` kernel at prefill, the superblock stack and the model
API (``init_params``, ``prefill``, ``serve_step``)."""
