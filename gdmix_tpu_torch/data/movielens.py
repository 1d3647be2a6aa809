"""movieLens data prep: the reference's GDMix input layout, TF-free.

Mirrors linkedin/gdmix:scripts/download_process_movieLens_data.py: builds
global / per_user / per_movie coordinate trees
(`{trainingData,validationData,metadata,featureList}`) with sparse
(indices,values) feature bags, uid/weight/user_id/movie_id columns and binarized
response, plus the DeText variant (doc_query + wide features + vocab).

Two sources:
  * a local ml-100k directory (u.data / u.item / u.user) when available
  * a SYNTHETIC generator (this environment has no network egress) that plants
    global, per-user and per-movie effects so the coordinate-descent pipeline
    exhibits the same AUC-lift structure as real movieLens
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from gdmix_tpu_torch.io.feature_list import write_feature_list
from gdmix_tpu_torch.io.input_pipeline import write_per_record
from gdmix_tpu_torch.io.metadata import DatasetMetadata

GENRE = ['unknown', 'Action', 'Adventure', 'Animation',
         'Childrens', 'Comedy', 'Crime', 'Documentary', 'Drama', 'Fantasy',
         'Film_Noir', 'Horror', 'Musical', 'Mystery', 'Romance', 'Sci_Fi',
         'Thriller', 'War', 'Western']
USER_FEATURE_VALUES = ['age', 'M', 'F', 'administrator', 'artist', 'doctor',
                       'educator', 'engineer', 'entertainment', 'executive',
                       'healthcare', 'homemaker', 'lawyer', 'librarian',
                       'marketing', 'none', 'other', 'programmer', 'retired',
                       'salesman', 'scientist', 'student', 'technician', 'writer']
MOVIE_FEATURE_VALUES = GENRE + ['release_date']
GLOBAL_FEATURE_VALUES = USER_FEATURE_VALUES + MOVIE_FEATURE_VALUES

_OCCUPATIONS = USER_FEATURE_VALUES[3:]


@dataclass
class RatingsData:
    """Joined interaction table + per-side sparse feature bags."""
    uid: np.ndarray            # [N] int64
    user_id: np.ndarray        # [N] int64
    movie_id: np.ndarray       # [N] int64
    response: np.ndarray       # [N] int64 {0,1}
    weight: np.ndarray         # [N] float32
    user_features: Dict[int, Tuple[np.ndarray, np.ndarray]]   # per-movie bag
    movie_features: Dict[int, Tuple[np.ndarray, np.ndarray]]  # per-user bag
    titles: Optional[Dict[int, str]] = None


def generate_synthetic(num_users: int = 400, num_movies: int = 600,
                       num_ratings: int = 40000, seed: int = 7) -> RatingsData:
    """Synthetic movieLens-like interactions with planted mixed effects."""
    rng = np.random.RandomState(seed)

    # Users: age (normalized), gender one-hot, occupation one-hot.
    user_feats: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    user_latent = {}
    for u in range(1, num_users + 1):
        age = rng.uniform(0.18, 0.65)
        gender = rng.choice([1, 2])                    # M=1, F=2 in the value list
        occ = 3 + rng.randint(len(_OCCUPATIONS))
        idx = np.array([0, gender, occ], dtype=np.int64)
        val = np.array([age, 1.0, 1.0])
        user_feats[u] = (idx, val)
        user_latent[u] = rng.randn() * 1.5             # per-user bias (random effect)

    # Movies: 1-3 genres one-hot + normalized release year.
    movie_feats: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    movie_latent = {}
    titles = {}
    words = ["star", "night", "city", "love", "dark", "return", "lost", "king",
             "dream", "storm", "day", "man", "girl", "house", "world", "last"]
    for m in range(1, num_movies + 1):
        n_genres = rng.randint(1, 4)
        genres = np.sort(rng.choice(len(GENRE), n_genres, replace=False))
        year = rng.uniform(0.92, 1.0)                  # year/2000
        idx = np.concatenate([genres, [len(GENRE)]]).astype(np.int64)
        val = np.concatenate([np.ones(n_genres), [year]])
        movie_feats[m] = (idx, val)
        movie_latent[m] = rng.randn() * 1.3            # per-movie bias
        titles[m] = " ".join(rng.choice(words, rng.randint(1, 4), replace=False))

    # Global effect vector over the GLOBAL feature space.
    w_global = rng.randn(len(GLOBAL_FEATURE_VALUES)) * 0.5

    # Long-tail activity skew (movieLens-like, but bounded so head users don't
    # swamp the sample-weighted AUC).
    user_pop = rng.pareto(2.5, num_users) + 1
    user_pop /= user_pop.sum()
    movie_pop = rng.pareto(2.0, num_movies) + 1
    movie_pop /= movie_pop.sum()

    users = rng.choice(np.arange(1, num_users + 1), num_ratings, p=user_pop)
    movies = rng.choice(np.arange(1, num_movies + 1), num_ratings, p=movie_pop)

    logits = np.empty(num_ratings)
    for i in range(num_ratings):
        u, m = users[i], movies[i]
        ui, uv = user_feats[u]
        mi, mv = movie_feats[m]
        g = (w_global[ui] * uv).sum() + \
            (w_global[mi + len(USER_FEATURE_VALUES)] * mv).sum()
        logits[i] = g + user_latent[u] + movie_latent[m]
    probs = 1.0 / (1.0 + np.exp(-(logits - np.median(logits))))
    response = (rng.rand(num_ratings) < probs).astype(np.int64)

    return RatingsData(
        uid=np.arange(num_ratings, dtype=np.int64),
        user_id=users.astype(np.int64), movie_id=movies.astype(np.int64),
        response=response, weight=np.ones(num_ratings, dtype=np.float32),
        user_features=user_feats, movie_features=movie_feats, titles=titles)


def load_ml100k(data_dir: str) -> RatingsData:
    """Parse a real ml-100k directory exactly like the reference prep script."""
    ratings = np.loadtxt(os.path.join(data_dir, "u.data"), dtype=np.int64)
    user_feats: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    with open(os.path.join(data_dir, "u.user")) as f:
        for line in f:
            uid_, age, gender, occupation, _zip = line.strip().split("|")
            idx = [0, 1 if gender == "M" else 2]
            val = [float(age) / 100.0, 1.0]
            if occupation in _OCCUPATIONS:
                idx.append(3 + _OCCUPATIONS.index(occupation))
                val.append(1.0)
            order = np.argsort(idx)
            user_feats[int(uid_)] = (np.asarray(idx, np.int64)[order],
                                     np.asarray(val)[order])
    movie_feats: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    titles: Dict[int, str] = {}
    with open(os.path.join(data_dir, "u.item"), encoding="ISO-8859-1") as f:
        for line in f:
            parts = line.strip().split("|")
            mid = int(parts[0])
            titles[mid] = parts[1]
            year = parts[2].split("-")[-1]
            release = float(year) / 2000.0 if year else 0.0
            genres = np.asarray([int(x) for x in parts[5:5 + len(GENRE)]])
            idx = list(np.flatnonzero(genres))
            val = [1.0] * len(idx)
            if abs(release) > 1e-6:
                idx.append(len(GENRE))
                val.append(release)
            movie_feats[mid] = (np.asarray(idx, np.int64), np.asarray(val))
    n = len(ratings)
    return RatingsData(
        uid=np.arange(n, dtype=np.int64),
        user_id=ratings[:, 0], movie_id=ratings[:, 1],
        response=(ratings[:, 2] > 3).astype(np.int64),
        weight=np.ones(n, dtype=np.float32),
        user_features=user_feats, movie_features=movie_feats, titles=titles)


def _bag_for(data: RatingsData, which: str, i: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    u, m = int(data.user_id[i]), int(data.movie_id[i])
    uidx, uval = data.user_features[u]
    midx, mval = data.movie_features[m]
    if which == "global":
        idx = np.concatenate([uidx, midx + len(USER_FEATURE_VALUES)])
        val = np.concatenate([uval, mval])
        return idx, val
    if which == "per_user":       # per-user models see movie features
        return midx, mval
    return uidx, uval             # per_movie: user features


def _metadata_json(bag: str, size: int, n_train: int) -> dict:
    return {
        "features": [
            {"name": bag, "dtype": "float", "shape": [size], "isSparse": True},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "weight", "dtype": "float", "shape": [], "isSparse": False},
            {"name": "movie_id", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "user_id", "dtype": "long", "shape": [], "isSparse": False}],
        "labels": [{"name": "response", "dtype": "int", "shape": [],
                    "isSparse": False}],
        "numberOfTrainingSamples": n_train,
    }


def prepare_gdmix_data(output_dir: str, data: Optional[RatingsData] = None,
                       train_fraction: float = 0.8, seed: int = 0,
                       with_detext: bool = False) -> str:
    """Write the three coordinate trees (+ optional detext tree). Returns the
    movieLens root dir."""
    if data is None:
        data = generate_synthetic()
    rng = np.random.RandomState(seed)
    n = len(data.uid)
    train_mask = rng.uniform(0, 1, n) < train_fraction

    root = os.path.join(output_dir, "movieLens")
    bags = {"global": GLOBAL_FEATURE_VALUES, "per_user": MOVIE_FEATURE_VALUES,
            "per_movie": USER_FEATURE_VALUES}
    for bag, feature_values in bags.items():
        ragged_idx = []
        ragged_val = []
        for i in range(n):
            idx, val = _bag_for(data, bag, i)
            ragged_idx.append(idx)
            ragged_val.append(val)
        md = DatasetMetadata.from_json(
            _metadata_json(bag, len(feature_values), int(train_mask.sum())))
        columns = {"uid": data.uid, "weight": data.weight,
                   "movie_id": data.movie_id, "user_id": data.user_id,
                   "response": data.response}
        for split, mask in (("trainingData", train_mask),
                            ("validationData", ~train_mask)):
            d = os.path.join(root, bag, split)
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            sel = np.flatnonzero(mask)
            write_per_record(
                os.path.join(d, f"{split[:5]}_data.tfrecord"), md,
                {k: v[sel] for k, v in columns.items()}, bag,
                [ragged_idx[i] for i in sel], [ragged_val[i] for i in sel])
        md_dir = os.path.join(root, bag, "metadata")
        shutil.rmtree(md_dir, ignore_errors=True)
        os.makedirs(md_dir)
        md.save(os.path.join(md_dir, "tensor_metadata.json"))
        fl_dir = os.path.join(root, bag, "featureList")
        shutil.rmtree(fl_dir, ignore_errors=True)
        os.makedirs(fl_dir)
        write_feature_list(feature_values, os.path.join(fl_dir, bag))

    if with_detext and data.titles is not None:
        _prepare_detext(root, data, train_mask)
    return root


def _prepare_detext(root: str, data: RatingsData, train_mask: np.ndarray) -> None:
    """DeText layout: doc_query (title bytes), wide sparse features (global bag
    shifted by +1), response as float, vocab.txt."""
    n = len(data.uid)
    detext_dir = os.path.join(root, "detext")
    md = DatasetMetadata.from_json({
        "features": [
            {"name": "wide_ftrs_sp", "dtype": "float",
             "shape": [len(GLOBAL_FEATURE_VALUES) + 1], "isSparse": True},
            {"name": "doc_query", "dtype": "string", "shape": [], "isSparse": False},
            {"name": "uid", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "weight", "dtype": "float", "shape": [], "isSparse": False},
            {"name": "movie_id", "dtype": "long", "shape": [], "isSparse": False},
            {"name": "user_id", "dtype": "long", "shape": [], "isSparse": False}],
        "labels": [{"name": "response", "dtype": "float", "shape": [],
                    "isSparse": False}],
        "numberOfTrainingSamples": int(train_mask.sum())})

    queries = np.asarray([data.titles[int(m)] for m in data.movie_id],
                         dtype=object)
    columns = {"uid": data.uid, "weight": data.weight,
               "movie_id": data.movie_id, "user_id": data.user_id,
               "doc_query": queries,
               "response": data.response.astype(np.float32)}
    ragged_idx, ragged_val = [], []
    for i in range(n):
        idx, val = _bag_for(data, "global", i)
        ragged_idx.append(idx + 1)     # DeText convention: indices start at 1
        ragged_val.append(val)
    for split, name, mask in (("trainingData", "train_data", train_mask),
                              ("validationData", "test_data", ~train_mask)):
        d = os.path.join(detext_dir, split)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        sel = np.flatnonzero(mask)
        write_per_record(os.path.join(d, f"{name}.tfrecord"), md,
                         {k: v[sel] for k, v in columns.items()}, "wide_ftrs_sp",
                         [ragged_idx[i] for i in sel],
                         [ragged_val[i] for i in sel])
    md_dir = os.path.join(detext_dir, "metadata")
    shutil.rmtree(md_dir, ignore_errors=True)
    os.makedirs(md_dir)
    md.save(os.path.join(md_dir, "tensor_metadata.json"))

    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    seen = set(vocab)
    for t in data.titles.values():
        for w in t.split():
            if w not in seen:
                seen.add(w)
                vocab.append(w)
    with open(os.path.join(detext_dir, "vocab.txt"), "w") as f:
        for v in vocab:
            f.write(f"{v}\n")


def prepare(output_dir: str, ml100k_dir: Optional[str] = None,
            with_detext: bool = True, **synth_kwargs) -> str:
    data = (load_ml100k(ml100k_dir) if ml100k_dir and
            os.path.exists(os.path.join(ml100k_dir, "u.data"))
            else generate_synthetic(**synth_kwargs))
    return prepare_gdmix_data(output_dir, data, with_detext=with_detext)
