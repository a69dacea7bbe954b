"""repro_torch — the PyTorch / CUDA port of the Fast-Node2Vec walk engine.

Mirrors ``repro`` (``core/``, ``data/``, ``engine/``, ``kernels/``) module
for module, imports ``torch`` and numpy only, and runs on the card unless a
caller passes ``device="cpu"``::

    from repro_torch.engine import WalkEngine, WalkPlan
    eng = WalkEngine.build("wec:k=10,deg=30", WalkPlan(backend="fused"))
    walks = eng.run(seed=0).walks
"""
