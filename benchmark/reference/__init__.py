"""The plain reference of the benchmark: Probabilistic Teacher's training iteration in
plain PyTorch, f32, computed again from the files, the weights and the draws that the
program was given. It imports nothing of the program."""
