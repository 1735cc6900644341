"""The model families (transformer, MoE, hybrid, xLSTM, encoder-decoder),
their config and parameter trees."""
