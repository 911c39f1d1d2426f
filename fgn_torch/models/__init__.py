"""FGN model: ResNet-50-C4 backbone, AG-RPN, relation and mask heads."""
