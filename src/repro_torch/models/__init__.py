"""Conv-graph IR and the VGG / ResNet graphs; the LM stack (layers,
embedding and loss, attention, MoE, SSM, transformer, encoder-decoder,
api)."""
