"""A random forest on the host, for the variant grid's ``-a rf``.

The reference fits scikit-learn's ``RandomForestClassifier(n_estimators=10,
random_state=seed)`` (wganlpctsemi.py:204-221), which the machine with the
card does not have. This module copies scikit-learn 1.9.0's algorithm for
dense rows in numpy, draw for draw, as ``train.splits`` copies its
``train_test_split``, so that the same seed grows the same trees:

- the forest's ``RandomState(random_state)`` draws one seed a tree
  (``randint(2**31 - 1)``); a tree's bootstrap is ``RandomState(seed)
  .randint(0, n, n)``, and a row drawn k times weighs k (rows drawn no time
  are out of the tree);
- each tree's feature draws come from scikit-learn's 32-bit xorshift
  (``utils/_random.pxd::our_rand_r``), seeded by a fresh
  ``RandomState(seed).randint(0, 2**31 - 1)``, through the Fisher-Yates walk
  of ``tree/_splitter.pyx::node_split_best`` over one feature array that
  persists from node to node: ``max_features = max(1,
  int(sqrt(n_features)))`` features a node, features found constant in the
  node (and those known constant from its ancestors) counting as drawn, and
  drawing goes on until one non-constant feature is among the drawn;
- the Gini criterion on the weighted class counts, its proxy computed in
  float64 as ``_criterion.pyx`` computes it; every position between two
  values more than 1e-7 apart is a candidate, the first of equal maxima in
  draw order wins, the threshold is the mean of the two values, and rows
  with x <= threshold go left;
- no depth limit: a node is a leaf when it holds fewer than 2 rows, when its
  impurity is at most float64 eps, or when no drawn feature varies in it;
  nodes are grown depth first, left child first (``_tree.pyx``);
- a leaf holds its weighted class fractions; the forest sums the trees'
  fractions in tree order, divides by the tree count, and predicts the
  first class of largest mean.

The features are float32, as scikit-learn casts them. A node's split search
is vectorized over its drawn features and rows; the draws are a Python loop.
"""

import numpy as np

# scikit-learn's constants: tree/_splitter.pyx, tree/_tree.pyx,
# utils/_random.pxd, ensemble/_forest.py
FEATURE_THRESHOLD = 1e-7
EPSILON = np.finfo(np.float64).eps
RAND_R_MAX = 2147483647
MAX_INT = np.iinfo(np.int32).max


class XorShift:
    """scikit-learn's ``our_rand_r`` / ``rand_int``: a 32-bit xorshift whose
    outputs are taken modulo 2**31."""

    def __init__(self, seed):
        self.state = int(seed) & 0xFFFFFFFF

    def rand_int(self, low, high):
        """An integer in [low, high)."""
        s = self.state or 1
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = s
        return low + (s % (RAND_R_MAX + 1)) % (high - low)


def n_drawn_features(max_features, n_features):
    """Features a node draws: every one (None) or ``max(1, int(sqrt(n)))``
    ("sqrt")."""
    if max_features is None:
        return n_features
    if max_features == "sqrt":
        return max(1, int(np.sqrt(n_features)))
    raise ValueError("max_features must be None or 'sqrt', got %r"
                     % (max_features,))


def gini_proxy(left, right):
    """scikit-learn's ``Gini.proxy_impurity_improvement`` for weighted class
    counts (..., classes) left and right of each candidate position, with
    its operations in its order."""
    w_left, w_right = left.sum(-1), right.sum(-1)
    sq_left = np.zeros(left.shape[:-1])
    sq_right = np.zeros(right.shape[:-1])
    for c in range(left.shape[-1]):
        sq_left = sq_left + left[..., c] * left[..., c]
        sq_right = sq_right + right[..., c] * right[..., c]
    with np.errstate(divide="ignore", invalid="ignore"):
        imp_left = 1.0 - sq_left / (w_left * w_left)
        imp_right = 1.0 - sq_right / (w_right * w_right)
    return -w_right * imp_right - w_left * imp_left


def best_split(vals, counts):
    """The best Gini split over the candidate features of a node: ``vals``
    (k, n) their float32 values in draw order, ``counts`` (n, classes) each
    row's weighted one-hot label. Returns (index into the k candidates,
    threshold) or None."""
    order = np.argsort(vals, axis=1, kind="stable")
    sorted_vals = np.take_along_axis(vals, order, axis=1).astype(np.float64)
    left = np.cumsum(counts[order], axis=1)[:, :-1]    # (k, n - 1, classes)
    right = counts.sum(axis=0) - left
    valid = sorted_vals[:, 1:] > sorted_vals[:, :-1] + FEATURE_THRESHOLD
    if not valid.any():
        return None
    proxy = np.where(valid, gini_proxy(left, right), -np.inf)
    k, p = np.unravel_index(np.argmax(proxy), proxy.shape)
    return int(k), sorted_vals[k, p] / 2.0 + sorted_vals[k, p + 1] / 2.0


class DecisionTree:
    """``DecisionTreeClassifier(max_features=..., random_state=...)``'s tree
    (Gini, best splits, no depth limit; see the module docstring).
    ``max_features``: "sqrt", or None for every feature."""

    def __init__(self, max_features=None, random_state=None):
        self.max_features = max_features
        self.random_state = random_state

    def _draw(self, rand, xt_rows, n_known):
        """``node_split_best``'s feature draws for one node: (the non-constant
        features drawn, in draw order; the node's count of known constant
        features for its children). ``xt_rows``: (features, rows) values."""
        features, constant = self.features_, self.constant_features_
        n_features = len(features)
        f_i = n_features
        visited = n_found = n_drawn = 0
        n_total = n_known
        drawn = []
        while f_i > n_total and (visited < self.n_drawn_
                                 or visited <= n_found + n_drawn):
            visited += 1
            f_j = rand.rand_int(n_drawn, f_i - n_found)
            if f_j < n_known:
                features[[n_drawn, f_j]] = features[[f_j, n_drawn]]
                n_drawn += 1
                continue
            f_j += n_found
            col = xt_rows[features[f_j]]
            if float(col.max()) <= float(col.min()) + FEATURE_THRESHOLD:
                features[[f_j, n_total]] = features[[n_total, f_j]]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            features[[f_i, f_j]] = features[[f_j, f_i]]
            drawn.append(features[f_i])
        features[:n_known] = constant[:n_known]
        constant[n_known:n_total] = features[n_known:n_total]
        return drawn, n_total

    def fit(self, x, y, sample_weight=None, n_classes=None):
        """``y``: class indices 0..n_classes-1; rows of weight 0 are out.
        The feature draws are seeded by a fresh
        ``RandomState(random_state)``'s first ``randint(0, 2**31 - 1)``."""
        x = np.asarray(x, np.float32)
        y = np.asarray(y)
        rand = XorShift(np.random.RandomState(self.random_state).randint(
            0, RAND_R_MAX))
        n_classes = int(y.max()) + 1 if n_classes is None else n_classes
        w = (np.ones(len(y)) if sample_weight is None
             else np.asarray(sample_weight, np.float64))
        onehot = np.zeros((len(y), n_classes))
        onehot[np.arange(len(y)), y] = w
        xt = np.ascontiguousarray(x.T)
        self.n_drawn_ = n_drawn_features(self.max_features, x.shape[1])
        self.features_ = np.arange(x.shape[1])
        self.constant_features_ = np.zeros(x.shape[1], np.intp)
        feature, threshold, left, right, value = [], [], [], [], []

        def node(rows):
            feature.append(-1)
            threshold.append(0.0)
            left.append(-1)
            right.append(-1)
            counts = onehot[rows].sum(axis=0)
            value.append(counts / counts.sum())
            return len(feature) - 1

        root = np.flatnonzero(w > 0)
        stack = [(node(root), root, 0)]
        while stack:
            i, rows, n_known = stack.pop()
            p = value[i]
            if len(rows) < 2 or 1.0 - (p * p).sum() <= EPSILON:
                continue
            xt_rows = xt[:, rows]
            drawn, n_known = self._draw(rand, xt_rows, n_known)
            split = (best_split(xt_rows[drawn], onehot[rows])
                     if drawn else None)
            if split is None:
                continue
            feature[i], threshold[i] = drawn[split[0]], split[1]
            go_left = xt_rows[feature[i]].astype(np.float64) <= threshold[i]
            # pushed right then left: the left child is grown first
            for side, child_rows in ((right, rows[~go_left]),
                                     (left, rows[go_left])):
                side[i] = node(child_rows)
                stack.append((side[i], child_rows, n_known))
        self.feature_ = np.asarray(feature)
        self.threshold_ = np.asarray(threshold, np.float64)
        self.left_ = np.asarray(left)
        self.right_ = np.asarray(right)
        self.value_ = np.asarray(value)
        return self

    def apply(self, x):
        """Each row's leaf."""
        x = np.asarray(x, np.float32)
        at = np.zeros(len(x), np.intp)
        inner = self.feature_[at] >= 0
        while inner.any():
            rows = np.flatnonzero(inner)
            node = at[rows]
            go_left = (x[rows, self.feature_[node]].astype(np.float64)
                       <= self.threshold_[node])
            at[rows] = np.where(go_left, self.left_[node], self.right_[node])
            inner = self.feature_[at] >= 0
        return at

    def predict_proba(self, x):
        return self.value_[self.apply(x)]


class RandomForest:
    """``RandomForestClassifier(n_estimators, random_state)``: bootstrap,
    "sqrt" features a node, Gini, soft voting (see the module docstring)."""

    def __init__(self, n_estimators=10, random_state=None):
        self.n_estimators = n_estimators
        self.random_state = random_state

    def fit(self, x, y):
        x = np.asarray(x, np.float32)
        self.classes_, y = np.unique(np.asarray(y), return_inverse=True)
        rng = np.random.RandomState(self.random_state)
        seeds = [rng.randint(MAX_INT) for _ in range(self.n_estimators)]
        self.trees_ = []
        for seed in seeds:
            weight = np.bincount(np.random.RandomState(seed).randint(
                0, len(y), len(y)), minlength=len(y))
            self.trees_.append(DecisionTree("sqrt", seed).fit(
                x, y, weight, len(self.classes_)))
        return self

    def predict_proba(self, x):
        proba = np.zeros((len(x), len(self.classes_)))
        for tree in self.trees_:
            proba += tree.predict_proba(x)
        return proba / len(self.trees_)

    def predict(self, x):
        return self.classes_[np.argmax(self.predict_proba(x), axis=1)]

    def score(self, x, y):
        return float(np.mean(self.predict(x) == np.asarray(y)))
