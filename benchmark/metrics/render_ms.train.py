"""Device ms a trainer step under the program's range "train.render"
(train/baseline.py::train_step, train/guided.py::train_step_guided: the
render of the train view, or of the train and pseudo views as one chain),
backward kernels counted with the forward op whose autograd node runs
them."""

MOVES = "train_step_ms"
LABEL = "train.render"


def read(view):
    s = view.label_s.get(LABEL)
    return None if not s else s / view.steps * 1e3
