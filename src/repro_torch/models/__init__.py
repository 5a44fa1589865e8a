"""Conv-graph IR and the VGG / ResNet graphs; the dense-decoder LM
stack (layers, embedding, attention, transformer, api)."""
