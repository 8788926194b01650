"""Model definitions of the port: config, layers, GQA attention, MoE,
blocks and the stacked-layer model, in the reference's parameter layout."""
