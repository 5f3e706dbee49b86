"""Training: AdamW with float32 master weights (`optimizer`), the train
step with gradient accumulation (`train_step`) and int8 gradient
compression with error feedback (`grad_compress`), the reference's
`repro.train`."""
