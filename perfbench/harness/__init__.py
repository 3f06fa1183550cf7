"""The benchmark's general machinery: loading a cell by name, the device,
traffic, weights, the synthetic tokenizer, the trace and the roofline."""
