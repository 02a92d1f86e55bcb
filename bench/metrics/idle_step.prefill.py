"""Device-idle seconds of the traced window inside the program's ``step``
spans (the host issuing a hop's pooled step), over the window, in %
(bench/program.py: each idle instant credited to the innermost program
span open at it).
"""
import program


def read(w):
    return program.idle_share_in(w, "step")
