"""Conv-graph IR and the VGG / ResNet builders."""
