"""The plain reference: PyTorch and numpy only, nothing of the program.

It works out again from the benchmark's own scene arrays everything the
program derives (world triangles, shading attributes, camera, sky) and
answers ray queries by brute force.  A frozen copy of the program's
definitions serves where the reference renderer defines the arithmetic
(the RNG, the BRDF); no module here imports the program, JAX or the JAX
package.
"""
