"""The benchmark's plain reference: ESM2 and ESMC in float32 PyTorch
(:mod:`.model`), an independent reading of the FASTA inputs and of the
batches built from them (:mod:`.data`), and the numbers that compare the
program's outputs with the reference's (:mod:`.compare`).

Nothing here imports the program under test or its JAX original: the
reference takes the weights and inputs the benchmark made and works out
everything else again.
"""
