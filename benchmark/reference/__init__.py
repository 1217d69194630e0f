"""The plain reference the benchmark judges the program's answers by.

Plain PyTorch; it imports nothing of the program, of JAX or of the JAX
package, and takes nothing the program made: it works its state out
again from the inputs the harness generated.
"""
