"""repro_torch — the PyTorch / CUDA port of Fast-Node2Vec: the walk engine,
streamed SGNS training and LM serving.

Mirrors ``repro`` (``core/``, ``data/``, ``engine/``, ``kernels/``,
``optim/``, ``train/``, ``checkpoint/``, ``runtime/``, ``configs/``,
``models/``, ``launch/``) module for module,
imports ``torch`` and numpy only, and runs on the card unless a caller
passes ``device="cpu"``::

    from repro_torch.engine import WalkEngine, WalkPlan
    eng = WalkEngine.build("wec:k=10,deg=30", WalkPlan(backend="fused"))
    walks = eng.run(seed=0).walks

    from repro_torch.core.node2vec import Node2VecConfig
    from repro_torch.train.stream import train_streamed
    emb, stats = train_streamed("wec:k=10,deg=30", Node2VecConfig(
        num_walks=2, sgns_backend="fused"))

    from repro_torch import configs, random
    from repro_torch.models import model
    cfg = configs.smoke_config("yi-6b")
    params = model.init_params(cfg, random.PRNGKey(0))
    logits, caches = model.prefill(cfg, params, {"tokens": tokens}, 64)
"""
