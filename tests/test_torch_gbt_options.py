"""The three-class configuration of the committed fixture
train_gbt_options (subsample 0.8 and half the features as candidates on
three classes: one row sample an iteration shared by its K trees, each
class's tree drawing its candidate features from its own key
fold_in(key, k)) trained by the CPU port: every tree by hash, the kept
count, the validation losses and the predictions bitwise. Its own file:
90 trees at 20,000 rows take about half a minute on one CPU thread.
"""

from test_torch_gbt_losses import check_option


def test_three_class_configuration_matches_the_fixture():
    check_option("three_class")
