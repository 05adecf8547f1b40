"""One loop a kind of traffic (``"kind"`` in ``traffic/<mix>.json``):
``worklist`` serves volumes in a closed loop, ``train`` runs the training
micro-step on one card or data-parallel over several."""
