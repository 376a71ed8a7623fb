"""The LM scaffolding's models: config schema (`config`), building blocks
(`layers`), the MoE FFN (`moe`), Mamba-2's SSD (`ssm`), the RG-LRU
(`rglru`), the decoder, Mamba-2 and hybrid LMs (`lm`), the encoder-decoder
(`encdec`), the VLM (`vlm`) and the factory (`model`)."""
