"""The benchmark's plain reference: `interp` (a job's execution) and
`verify` (a job's proof, by `frozen/`, a copy of the port's verifier and
the modules it reads, frozen as the port stood when the benchmark was
written; `frozen/_build.py` takes the place of the kernels, which the copy
never reaches on CPU tensors).  Nothing here imports the program under
test, JAX or the JAX package."""
