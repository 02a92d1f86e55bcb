"""The live share of the pooled steps' (layer x row x position) work: the
sum of the program's ``work_live`` counts over its ``work_run`` counts, on
the ``hop`` spans of the rounds that ended inside the window, in %.
``work_run`` is hosted layers x pool rows x positions (1 a decode step,
the padded chunk a prefill step); ``work_live`` the members' route layers
x their live positions.
"""
import program


def read(w):
    return program.live_work(w)
