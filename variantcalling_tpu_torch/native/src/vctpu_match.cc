// Native haplotype-aware variant matcher (vcfeval-equivalent core).
//
// Faithful port of comparison/matcher.py::match_contig — the reference
// delegates TP/FP/FN matching to rtg vcfeval (Java) as a black box
// (docs/run_comparison_pipeline.md:3-5); this framework's engine is
// in-process. Python remains the specification (and the fallback); the
// parity fuzz test asserts identical outputs on random + adversarial
// inputs. Stages: normalize -> exact join on (pos, ref, alt) -> bounded
// diploid haplotype search over gap-clustered residue, run at the allele
// level then the genotype level with failed-cluster memoization.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace vmatch {

static const int MAX_CLUSTER_VARIANTS = 16;  // mirror matcher.py caps
static const int MAX_HETS = 12;
static const size_t PHASING_BEAM = 4096;  // dedup-BFS state cap (matcher.py)
static const int64_t CLUSTER_GAP = 30;
static const int64_t FLANK = 10;

struct Variant {
    int64_t pos = 0;  // 1-based
    std::string ref;
    std::vector<std::string> alts;
    int8_t gt[2] = {-1, -1};
};

struct Key {
    int64_t pos;
    std::string ref;
    std::string alt;
    bool operator==(const Key& o) const {
        return pos == o.pos && ref == o.ref && alt == o.alt;
    }
    bool operator<(const Key& o) const {
        if (pos != o.pos) return pos < o.pos;
        if (ref != o.ref) return ref < o.ref;
        return alt < o.alt;
    }
};

struct KeyHash {
    size_t operator()(const Key& k) const {
        size_t h = std::hash<int64_t>()(k.pos);
        h = h * 1000003 ^ std::hash<std::string>()(k.ref);
        h = h * 1000003 ^ std::hash<std::string>()(k.alt);
        return h;
    }
};

static bool symbolic_alt(const std::string& a) {
    return a == "." || a.empty() || a == "*" || a == "<NON_REF>" ||
           (!a.empty() && a[0] == '<');
}

// matcher.py::normalize_variant — trim shared suffix then prefix
static Key normalize(int64_t pos, std::string ref, std::string alt) {
    while (ref.size() > 1 && alt.size() > 1 && ref.back() == alt.back()) {
        ref.pop_back();
        alt.pop_back();
    }
    while (ref.size() > 1 && alt.size() > 1 && ref[0] == alt[0]) {
        ref.erase(0, 1);
        alt.erase(0, 1);
        pos += 1;
    }
    return Key{pos, std::move(ref), std::move(alt)};
}

// matcher.py::_called_allele_keys
static std::set<Key> called_allele_keys(const Variant& v) {
    std::set<int> called;
    for (int j = 0; j < 2; j++)
        if (v.gt[j] > 0) called.insert(v.gt[j]);
    std::set<Key> out;
    if (called.empty()) {  // no GT: all alts
        for (const auto& a : v.alts)
            if (!symbolic_alt(a)) out.insert(normalize(v.pos, v.ref, a));
        return out;
    }
    for (int ai : called) {
        if (ai - 1 < (int)v.alts.size()) {
            const std::string& a = v.alts[ai - 1];
            if (!symbolic_alt(a)) out.insert(normalize(v.pos, v.ref, a));
        }
    }
    return out;
}

// matcher.py::_gt_equivalent — same zygosity over equivalent alleles
static std::vector<std::string> gt_pattern(const Variant& v) {
    std::vector<int> g;
    for (int j = 0; j < 2; j++)
        if (v.gt[j] >= 0) g.push_back(v.gt[j]);
    std::vector<std::string> keys;
    if (g.empty()) {
        keys.push_back("('any',)");
        return keys;
    }
    std::sort(g.begin(), g.end());
    for (int a : g) {
        if (a == 0) {
            keys.push_back("('ref',)");
        } else if (a - 1 < (int)v.alts.size()) {
            Key k = normalize(v.pos, v.ref, v.alts[a - 1]);
            // mirror python str() of the tuple (pos, ref, alt)
            keys.push_back("(" + std::to_string(k.pos) + ", '" + k.ref + "', '" + k.alt + "')");
        }
    }
    std::sort(keys.begin(), keys.end());
    return keys;
}

static bool gt_equivalent(const Variant& a, const Variant& b) {
    auto pa = gt_pattern(a), pb = gt_pattern(b);
    if (pa == pb) return true;
    std::vector<std::string> any{"('any',)"};
    return pa == any || pb == any;
}

// matcher.py::_apply — non-overlapping edits over the window
static bool apply_edits(const std::string& window,
                        std::vector<std::tuple<int64_t, int64_t, std::string>> edits,
                        std::string& out) {
    std::sort(edits.begin(), edits.end());
    out.clear();
    int64_t cur = 0;
    for (auto& [s0, e0, alt] : edits) {
        if (s0 < cur || e0 > (int64_t)window.size() || s0 < 0) return false;
        out.append(window, cur, s0 - cur);
        out.append(alt);
        cur = e0;
    }
    out.append(window, cur, window.size() - cur);
    return true;
}

// One partial haplotype of the dedup-BFS: sequence built so far + the
// reference position consumed through (matcher.py::_extend_hap).
struct PartialHap {
    std::string built;
    int64_t cur = 0;
    bool operator<(const PartialHap& o) const {
        if (built != o.built) return built < o.built;
        return cur < o.cur;
    }
    bool operator==(const PartialHap& o) const { return built == o.built && cur == o.cur; }
};

static bool extend_hap(const PartialHap& h, const std::string& window, int64_t s0, int64_t e0,
                       const std::string& alt, PartialHap& out) {
    if (s0 < h.cur || e0 > (int64_t)window.size() || s0 < 0) return false;
    out.built.assign(h.built);
    out.built.append(window, h.cur, s0 - h.cur);
    out.built.append(alt);
    out.cur = e0;
    return true;
}

// matcher.py::_diploid_haplotypes — all {hapA, hapB} pairs over phasings,
// enumerated by a dedup-BFS over sorted edits (unordered partial pairs,
// deduplicated per step) instead of 2^hets masks. Exact whenever the
// state count stays within PHASING_BEAM. Returns false with capped=true
// when the search hit MAX_HETS / the beam (caller counts the exact-only
// degradation); false with capped=false when no phasing replays.
static bool diploid_haplotypes(const std::vector<Variant>& side, const std::vector<int>& idx,
                               int64_t lo, const std::string& window,
                               std::set<std::pair<std::string, std::string>>& out,
                               bool& capped) {
    struct Edit {
        int64_t s0, e0;
        std::string alt;
        bool both;
        bool operator<(const Edit& o) const {
            if (s0 != o.s0) return s0 < o.s0;
            if (e0 != o.e0) return e0 < o.e0;
            return alt < o.alt;
        }
    };
    capped = false;
    std::vector<Edit> applied;
    int n_hets = 0;
    for (int k : idx) {
        const Variant& v = side[k];
        std::vector<int> g;
        for (int j = 0; j < 2; j++)
            if (v.gt[j] >= 0) g.push_back(v.gt[j]);
        std::set<int> alleles;
        for (int a : g)
            if (a > 0) alleles.insert(a);
        if (alleles.empty() && !v.alts.empty()) alleles.insert(1);
        for (int ai : alleles) {
            if (ai - 1 >= (int)v.alts.size()) return false;
            const std::string& alt = v.alts[ai - 1];
            if (symbolic_alt(alt)) continue;
            int64_t s0 = v.pos - lo;
            int64_t e0 = s0 + (int64_t)v.ref.size();
            int nz = 0;
            bool has_ref = false;
            int count_ai = 0;
            for (int a : g) {
                if (a > 0) nz++;
                if (a == 0) has_ref = true;
                if (a == ai) count_ai++;
            }
            bool hom = (int)g.size() >= 2 && count_ai == nz && !has_ref;
            applied.push_back({s0, e0, alt, hom});
            if (!hom) n_hets++;
        }
    }
    if (n_hets > MAX_HETS) {
        capped = true;
        return false;
    }
    std::sort(applied.begin(), applied.end());

    using State = std::pair<PartialHap, PartialHap>;  // kept ordered (a <= b)
    std::set<State> states;
    states.insert({PartialHap{}, PartialHap{}});
    PartialHap na, nb;
    for (const Edit& e : applied) {
        std::set<State> next;
        for (const State& st : states) {
            if (e.both) {
                if (extend_hap(st.first, window, e.s0, e.e0, e.alt, na) &&
                    extend_hap(st.second, window, e.s0, e.e0, e.alt, nb)) {
                    if (nb < na) std::swap(na, nb);
                    next.insert({na, nb});
                }
            } else {
                if (extend_hap(st.first, window, e.s0, e.e0, e.alt, na)) {
                    nb = st.second;
                    if (nb < na) std::swap(na, nb);
                    next.insert({na, nb});
                }
                if (extend_hap(st.second, window, e.s0, e.e0, e.alt, nb)) {
                    na = st.first;
                    if (nb < na) std::swap(na, nb);
                    next.insert({na, nb});
                }
            }
        }
        if (next.empty()) return false;  // no phasing can replay these edits
        if (next.size() > PHASING_BEAM) {
            capped = true;
            return false;
        }
        states.swap(next);
    }

    out.clear();
    for (const State& st : states) {
        std::string a = st.first.built;
        a.append(window, st.first.cur, window.size() - st.first.cur);
        std::string b = st.second.built;
        b.append(window, st.second.cur, window.size() - st.second.cur);
        if (a <= b)
            out.insert({a, b});
        else
            out.insert({b, a});
    }
    return !out.empty();
}

// matcher.py::_clusters — gap-bounded residue clusters over both sides
struct Cluster {
    std::vector<int> c_idx, t_idx;
};

static std::vector<Cluster> make_clusters(const std::vector<Variant>& calls,
                                          const std::vector<Variant>& truth,
                                          const std::vector<int>& un_c,
                                          const std::vector<int>& un_t) {
    struct Ev {
        int64_t pos;
        int side;
        int idx;
        bool operator<(const Ev& o) const {
            if (pos != o.pos) return pos < o.pos;
            if (side != o.side) return side < o.side;
            return idx < o.idx;
        }
    };
    std::vector<Ev> evs;
    for (int i : un_c) evs.push_back({calls[i].pos, 0, i});
    for (int j : un_t) evs.push_back({truth[j].pos, 1, j});
    std::sort(evs.begin(), evs.end());
    std::vector<Cluster> out;
    Cluster cur;
    bool have_last = false;
    int64_t last = 0;
    for (const Ev& e : evs) {
        if (have_last && e.pos - last > CLUSTER_GAP && (!cur.c_idx.empty() || !cur.t_idx.empty())) {
            out.push_back(std::move(cur));
            cur = Cluster();
        }
        (e.side == 0 ? cur.c_idx : cur.t_idx).push_back(e.idx);
        last = e.pos;
        have_last = true;
    }
    if (!cur.c_idx.empty() || !cur.t_idx.empty()) out.push_back(std::move(cur));
    return out;
}

static void match_contig(const std::string& ref_seq, std::vector<Variant>& calls,
                         std::vector<Variant>& truth, uint8_t* call_tp, uint8_t* call_tp_gt,
                         uint8_t* truth_tp, uint8_t* truth_tp_gt, int64_t* call_truth_idx,
                         bool haplotype_rescue, int64_t* stats) {
    stats[0] = stats[1] = 0;  // capped clusters / variants in them (allele pass)
    size_t nc = calls.size(), nt = truth.size();
    std::fill(call_tp, call_tp + nc, 0);
    std::fill(call_tp_gt, call_tp_gt + nc, 0);
    std::fill(truth_tp, truth_tp + nt, 0);
    std::fill(truth_tp_gt, truth_tp_gt + nt, 0);
    std::fill(call_truth_idx, call_truth_idx + nc, -1);

    // ---- stage 2: exact normalized-key join (first truth wins, as python
    // dict setdefault) --------------------------------------------------
    std::unordered_map<Key, int, KeyHash> truth_by_key;
    for (size_t j = 0; j < nt; j++)
        for (const Key& k : called_allele_keys(truth[j]))
            truth_by_key.emplace(k, (int)j);
    for (size_t i = 0; i < nc; i++) {
        auto ck = called_allele_keys(calls[i]);
        if (ck.empty()) continue;
        std::set<int> hit_truth;
        size_t hits = 0;
        int first_j = -1;
        for (const Key& k : ck) {
            auto it = truth_by_key.find(k);
            if (it != truth_by_key.end()) {
                hits++;
                hit_truth.insert(it->second);
                if (first_j < 0) first_j = it->second;
            }
        }
        if (hits == ck.size()) {  // every called allele present in truth
            call_tp[i] = 1;
            call_truth_idx[i] = first_j;
            for (int jj : hit_truth) truth_tp[jj] = 1;
            if (hit_truth.size() == 1 && gt_equivalent(calls[i], truth[*hit_truth.begin()])) {
                call_tp_gt[i] = 1;
                truth_tp_gt[*hit_truth.begin()] = 1;
            }
        }
    }

    if (!haplotype_rescue) return;

    // ---- stage 3: bounded haplotype search, allele then genotype level --
    std::set<std::pair<std::vector<int>, std::vector<int>>> failed;
    for (int level = 0; level < 2; level++) {
        std::vector<int> un_c, un_t;
        for (size_t i = 0; i < nc; i++)
            if (!(level == 0 ? call_tp[i] : call_tp_gt[i])) un_c.push_back((int)i);
        for (size_t j = 0; j < nt; j++)
            if (!(level == 0 ? truth_tp[j] : truth_tp_gt[j])) un_t.push_back((int)j);
        for (const Cluster& cl : make_clusters(calls, truth, un_c, un_t)) {
            if (cl.c_idx.empty() || cl.t_idx.empty()) continue;
            auto ckey = std::make_pair(cl.c_idx, cl.t_idx);
            if (failed.count(ckey)) continue;
            if (level == 0) failed.insert(ckey);  // removed below on success
            if ((int)cl.c_idx.size() > MAX_CLUSTER_VARIANTS ||
                (int)cl.t_idx.size() > MAX_CLUSTER_VARIANTS) {
                if (level == 0) {
                    stats[0] += 1;
                    stats[1] += (int64_t)cl.c_idx.size() + (int64_t)cl.t_idx.size();
                }
                continue;
            }
            int64_t lo = INT64_MAX, hi = INT64_MIN;
            for (int i : cl.c_idx) {
                lo = std::min(lo, calls[i].pos);
                hi = std::max(hi, calls[i].pos + (int64_t)calls[i].ref.size());
            }
            for (int j : cl.t_idx) {
                lo = std::min(lo, truth[j].pos);
                hi = std::max(hi, truth[j].pos + (int64_t)truth[j].ref.size());
            }
            lo -= FLANK;
            hi += FLANK;
            lo = std::max<int64_t>(lo, 1);
            int64_t w_lo = lo - 1;
            int64_t w_hi = std::min<int64_t>(hi - 1, (int64_t)ref_seq.size());
            if (w_hi < w_lo) w_hi = w_lo;
            std::string window = ref_seq.substr(
                std::min<int64_t>(w_lo, (int64_t)ref_seq.size()), w_hi - w_lo);
            std::set<std::pair<std::string, std::string>> hc, ht;
            bool cap_c = false, cap_t = false;
            // both sides always evaluated (python parity: capped_t counts
            // even when the call side already failed un-capped)
            bool ok_c = diploid_haplotypes(calls, cl.c_idx, lo, window, hc, cap_c);
            bool ok_t = diploid_haplotypes(truth, cl.t_idx, lo, window, ht, cap_t);
            if (!ok_c || !ok_t) {
                if ((cap_c || cap_t) && level == 0) {
                    stats[0] += 1;
                    stats[1] += (int64_t)cl.c_idx.size() + (int64_t)cl.t_idx.size();
                }
                continue;
            }
            bool inter = false;
            for (const auto& p : hc)
                if (ht.count(p)) {
                    inter = true;
                    break;
                }
            if (inter) {
                failed.erase(ckey);
                for (int i : cl.c_idx) {
                    call_tp[i] = 1;
                    call_tp_gt[i] = 1;
                }
                for (int j : cl.t_idx) {
                    truth_tp[j] = 1;
                    truth_tp_gt[j] = 1;
                }
            }
        }
    }
}

// unpack one side from blob layout: ref/alt strings are plain-concatenated,
// delimited by the (n+1) byte-offset array (native/__init__.py::_pack);
// alts are comma-separated within a record, "" meaning no alts
static void unpack(std::vector<Variant>& out, int64_t n, const int64_t* pos,
                   const uint8_t* ref_blob, const int64_t* ref_offs, const uint8_t* alt_blob,
                   const int64_t* alt_offs, const int8_t* gt) {
    out.resize(n);
    for (int64_t i = 0; i < n; i++) {
        Variant& v = out[i];
        v.pos = pos[i];
        v.ref.assign((const char*)ref_blob + ref_offs[i], ref_offs[i + 1] - ref_offs[i]);
        std::string alts((const char*)alt_blob + alt_offs[i], alt_offs[i + 1] - alt_offs[i]);
        v.alts.clear();
        if (!alts.empty()) {  // "" = no alts; "." stays a literal entry
            size_t start = 0;
            while (start <= alts.size()) {
                size_t comma = alts.find(',', start);
                if (comma == std::string::npos) {
                    v.alts.push_back(alts.substr(start));
                    break;
                }
                v.alts.push_back(alts.substr(start, comma - start));
                start = comma + 1;
            }
        }
        v.gt[0] = gt[i * 2];
        v.gt[1] = gt[i * 2 + 1];
    }
}

}  // namespace vmatch

extern "C" {

int64_t vctpu_match_contig(
    const uint8_t* ref_seq, int64_t ref_len,
    int64_t n_calls, const int64_t* c_pos, const uint8_t* c_ref_blob, const int64_t* c_ref_offs,
    const uint8_t* c_alt_blob, const int64_t* c_alt_offs, const int8_t* c_gt,
    int64_t n_truth, const int64_t* t_pos, const uint8_t* t_ref_blob, const int64_t* t_ref_offs,
    const uint8_t* t_alt_blob, const int64_t* t_alt_offs, const int8_t* t_gt,
    int32_t haplotype_rescue,
    uint8_t* call_tp, uint8_t* call_tp_gt, uint8_t* truth_tp, uint8_t* truth_tp_gt,
    int64_t* call_truth_idx, int64_t* stats) {
    try {
        std::string seq((const char*)ref_seq, ref_len);
        std::vector<vmatch::Variant> calls, truth;
        vmatch::unpack(calls, n_calls, c_pos, c_ref_blob, c_ref_offs, c_alt_blob, c_alt_offs, c_gt);
        vmatch::unpack(truth, n_truth, t_pos, t_ref_blob, t_ref_offs, t_alt_blob, t_alt_offs, t_gt);
        vmatch::match_contig(seq, calls, truth, call_tp, call_tp_gt, truth_tp, truth_tp_gt,
                             call_truth_idx, haplotype_rescue != 0, stats);
        return 0;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
