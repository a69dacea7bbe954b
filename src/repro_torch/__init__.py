"""repro_torch — the PyTorch / CUDA port of Fast-Node2Vec: the walk engine
and streamed SGNS training.

Mirrors ``repro`` (``core/``, ``data/``, ``engine/``, ``kernels/``,
``optim/``, ``train/``, ``checkpoint/``, ``runtime/``) module for module,
imports ``torch`` and numpy only, and runs on the card unless a caller
passes ``device="cpu"``::

    from repro_torch.engine import WalkEngine, WalkPlan
    eng = WalkEngine.build("wec:k=10,deg=30", WalkPlan(backend="fused"))
    walks = eng.run(seed=0).walks

    from repro_torch.core.node2vec import Node2VecConfig
    from repro_torch.train.stream import train_streamed
    emb, stats = train_streamed("wec:k=10,deg=30", Node2VecConfig(
        num_walks=2, sgns_backend="fused"))
"""
